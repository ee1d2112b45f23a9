"""Data pipelines of the port: the synthetic RecSys datasets
(`synthetic.py`) and the LM token stream with its prefetcher
(`lm_data.py`)."""
