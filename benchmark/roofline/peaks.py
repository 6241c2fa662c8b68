"""Published dense peaks of the card (NVIDIA's H100 SXM data sheet,
without sparsity, at the part's full 700 W power limit).  A share of a peak
is stated against these, with the card's power limit beside it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "float32": 67e12,        # FP32 outside the tensor cores (TF32 off)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}
# 132 SMs x 16 special-function results per clock x 1.98 GHz boost (Hopper
# architecture white paper)
SFU_OPS_PER_S = 132 * 16 * 1.98e9
