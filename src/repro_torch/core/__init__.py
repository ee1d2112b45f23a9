"""Core ops of the serve path: int8 tables, LSH, top-K, the filtering NNS."""
