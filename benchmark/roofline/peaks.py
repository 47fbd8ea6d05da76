"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit): HBM3 bandwidth and the float32 rate outside the tensor
cores (an FMA counts as two operations)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    bandwidth and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
