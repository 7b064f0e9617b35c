"""K11's work: the assembly of a Newton pass's dense real system A x = b,
one system per variant per Newton pass that the inputs need (the
reference counts the passes), whatever form of the kernel runs.

Bytes a lane-pass: A and b written once, n^2 + n items, and each stamp
value that varies by lane read once (``lane_values``: counted from the
deck by the reference's own stamper, ``mna.lane_values``; the values
that every lane shares, the V sources', are read once a pass for all
lanes, not once a lane, and are left out). Operations a lane-pass: one
add for each matrix and right-hand-side entry the deck's stamps touch
(``stamp_adds``)."""


def work(n: int, lane_passes: float, lane_values: int, stamp_adds: int,
         itemsize: int) -> tuple[float, float]:
    flops = lane_passes * stamp_adds
    nbytes = lane_passes * (n * n + n + lane_values) * itemsize
    return flops, nbytes
