"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): HBM3 bandwidth, and the FP32 rate outside the
tensor cores, which is what float32 work with TF32 off runs at."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
