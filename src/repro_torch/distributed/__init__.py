"""Training of the port: the LM and RecSys train steps (`training.py`)
and the fault-tolerant loop (`fault_tolerance.py`). One device; the
reference's logical-axis sharding rules (`distributed/sharding.py`) are
not ported yet."""
