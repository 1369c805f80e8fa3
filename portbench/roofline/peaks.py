"""
Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  A share of a roofline or of a peak is stated
against these, with the card's power limit beside it.
"""

#: HBM3 bandwidth, bytes/s
BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, FLOP/s: the rate of G, B1 and B2, and of
#: a float32 product with TF32 off
F32_FLOP_PER_S = 67e12
