"""Data pipelines of the port: the synthetic RecSys datasets."""
