"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): the roofline's denominators."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for work of ``ops`` float32
    operations moving ``nbytes`` to or from HBM."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
