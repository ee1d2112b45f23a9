"""Training of the port: the LM and RecSys train steps (`training.py`),
the fault-tolerant loop (`fault_tolerance.py`), and the reference's
logical-axis sharding rules as DTensor placements (`sharding.py`; the
step builders that apply them are `launch/steps.py`)."""
