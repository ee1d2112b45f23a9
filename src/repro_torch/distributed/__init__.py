"""Training of the port: the RecSys train step (`training.py`) and the
fault-tolerant loop (`fault_tolerance.py`). One device; the multi-GPU
plans of the reference's `distributed/sharding.py` are not ported yet."""
