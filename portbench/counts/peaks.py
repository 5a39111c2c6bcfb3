"""The card's published peaks: one NVIDIA H100 SXM, dense rates, at its
700 W power limit (NVIDIA's data sheet)."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 on the CUDA cores (TF32 off)
TF32_OPS_PER_S = 495e12        # TF32 tensor cores
F32_3XTF32_OPS_PER_S = TF32_OPS_PER_S / 3   # float32-accurate 3xTF32
BF16_OPS_PER_S = 989e12
