"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): the roofline's ceilings."""

FLOAT32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(operations: float, nbytes: float) -> float:
    """Least time the card could take: the larger of the two bounds."""
    return max(operations / FLOAT32_FLOPS, nbytes / HBM_BYTES_PER_S)
