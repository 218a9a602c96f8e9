"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W): what roofline and utilisation shares
are taken against."""

#: f32 outside the tensor cores (TF32 stays off in every cell)
F32_FLOPS_PER_S = 67e12
#: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
