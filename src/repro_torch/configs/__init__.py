"""Model configs of the port: the reference's ten LM architectures (see
registry) and the paper's two RecSys models (`youtubednn_movielens.py`,
`dlrm_criteo.py`)."""
