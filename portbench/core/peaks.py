"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a run prints the card's limit
beside every share it reads).

float64 takes the FP64 tensor-core rate, the card's highest for that
precision; float32 the rate off the tensor cores (a hand-written kernel
in float32 does not use them; TF32 is not float32).
"""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float64": 67e12, "float32": 67e12}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of
    the operations at the peak rate and the bytes at the peak bandwidth."""
    return max(flops / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
