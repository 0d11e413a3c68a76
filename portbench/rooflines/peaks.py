"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full power limit of 700 W; the run's `card` line says
which card ran and at what limit."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def least_seconds(nbytes: float, ops: float, tf32_ops: float = 0.0) -> float:
    """The least time the card could take for the work: bytes over the
    memory rate or operations over the arithmetic rates, the larger."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops / FP32_OPS_PER_S + tf32_ops / TF32_OPS_PER_S)
