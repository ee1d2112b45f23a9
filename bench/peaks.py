"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Roofline shares and
`serve_mfu` are taken against these; the run's line names the card, and
`PERF.md` its power limit.

NVIDIA publishes no peak for 1-bit (`b1`) tensor-core products on the
H100, so a Hamming scan that moved to them would need its operations
recounted first.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, float32 without the tensor cores
INT8_OPS = 1979e12
# a Hamming (query, row) pair over 256-bit signatures as the int8 tensor
# cores run it: a 256-long +-1 dot product, one multiply and one add a bit
HAMMING_OPS_PER_BIT = 2
