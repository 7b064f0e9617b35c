"""K9's work: a whole nonlinear transient per variant, every Newton pass
the reference semantics need for these inputs (the reference counts
them), each pass one assembly and one dense real solve.

Operations a pass: the solve's 2n^3/3 + 2n^2, plus one add for each
matrix and right-hand-side entry the deck's stamps touch
(``stamp_adds``, counted from the deck by the reference's own stamper).
Bytes: the inputs once (the swept values, and the sources at every time
point) and the response once (the probed node at every time point)."""


def work(n: int, lane_passes: float, stamp_adds: int, variants: int,
         swept: int, points: int, sources: int, itemsize: int
         ) -> tuple[float, float]:
    flops = lane_passes * (2.0 * n ** 3 / 3.0 + 2.0 * n ** 2 + stamp_adds)
    nbytes = (variants * swept + points * sources
              + variants * points) * itemsize
    return flops, nbytes
