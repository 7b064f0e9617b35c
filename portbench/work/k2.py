"""K2's work: dense real systems A x = b, one per variant per Newton pass
that the inputs need (the reference counts the passes).

Operations: 2n^3/3 + 2n^2 a system (LU with partial pivoting and the
two triangular solves). Bytes: A and b read once, x written once."""


def work(n: int, systems: float, itemsize: int) -> tuple[float, float]:
    flops = systems * (2.0 * n ** 3 / 3.0 + 2.0 * n ** 2)
    nbytes = systems * (n * n + 2 * n) * itemsize
    return flops, nbytes
