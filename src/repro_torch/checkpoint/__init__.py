"""Checkpointing: atomic, asynchronous saves and checked restores."""
