"""Entry points: the serving driver (``serve``) and its cache layout
(``specs``)."""
