"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W power limit) and the least time a piece of work can take on it."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12            # HBM3, bytes/s


def bound_s(byte_count: float, ops: float, dtype: str = "bfloat16") -> float:
    """The larger of bytes / bandwidth and operations / the dtype's peak."""
    return max(byte_count / PEAK_BYTES, ops / PEAK_FLOPS[dtype])
