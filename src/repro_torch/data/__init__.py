"""Training data: the deterministic token source (``pipeline``)."""
