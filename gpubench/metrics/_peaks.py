"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit): the denominators of the roofline and mfu
shares."""

BF16_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s
HBM_BYTES = 3.35e12       # HBM3 bytes/s
