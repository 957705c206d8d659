"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity), at its full 700 W power limit."""

BF16_OPS_PER_S = 989e12  # bf16 and fp16 on the tensor cores
TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
