"""Optimizers of the port: the reference's AdamW (`optim/adamw.py`)."""
