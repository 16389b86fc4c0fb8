"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full power limit of 700 W): the yardstick of every roofline share and of
``mfu``.  A card set below 700 W reaches less; each run prints its limit."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
