"""Model configs of the port: the dense LM family (see registry) and the
paper's two RecSys models (`youtubednn_movielens.py`, `dlrm_criteo.py`)."""
