"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit). A card set below 700 W reaches less; the
result line carries the card's power limit beside every share of a peak."""

FP32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12       # bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12

PEAKS = {"float32": FP32_FLOPS, "tf32": TF32_FLOPS, "bfloat16": BF16_FLOPS}


def least_seconds(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS):
    """The least time the chip could take: the larger of the operations at
    their type's peak and the bytes at the memory's peak. Returns (seconds,
    "bytes" or "operations"), the side that bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
