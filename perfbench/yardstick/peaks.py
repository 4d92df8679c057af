"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), as ``repro_torch.launch.roofline`` states them."""

PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s
