"""The model stack: parameter specs (``params``), layers, the decoder LM
(``lm``) and weights carried across from the JAX package (``carry``)."""
