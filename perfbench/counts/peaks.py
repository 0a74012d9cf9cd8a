"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at the full 700 W): the denominators of every roofline and utilization.
Frozen with the benchmark: a later change cannot move them."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}
