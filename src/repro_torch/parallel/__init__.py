"""Step builders (``steps``): the training and serving steps on one card."""
