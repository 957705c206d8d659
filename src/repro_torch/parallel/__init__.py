"""Step builders (``steps``): the serving step on one card."""
