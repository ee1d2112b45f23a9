"""Optimizers of the port: the reference's AdamW (`optim/adamw.py`) and
int8 gradient compression with error feedback (`optim/compression.py`)."""
