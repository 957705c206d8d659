"""Optimizers: AdamW with a warmup-cosine schedule (``adamw``)."""
