"""Entry points: the trainer (``train``), the server (``serve``) and its
cache layout (``specs``)."""
