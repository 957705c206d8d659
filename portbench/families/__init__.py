"""One module a model family, found by the configuration's ``family``
(``catalog.family``): ``layout``, ``loss``, ``param_count``,
``model_flops`` and ``small``.  Each imports nothing of the program."""
