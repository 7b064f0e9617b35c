"""The program's own launch counters, read by kernel symbol.

Each hand-written kernel's wrapper counts its launches (``K2_TIERS``,
``K9_FORMS`` in ``spicey_tpu_torch.ops``): those of the kernels the cells
run.
``snapshot`` reads them under the device kernels' symbols, so the delta
over a few jobs can be set beside what the trace shows. A counter the
program no longer has reads as absent.
"""

from __future__ import annotations


def snapshot() -> dict[str, int]:
    from spicey_tpu_torch.ops import gj_real, mc_tran_fused

    out: dict[str, int] = {}

    def put(symbol: str, fn) -> None:
        try:
            out[symbol] = int(fn())
        except (AttributeError, KeyError, TypeError):
            pass

    put("gj_real_thread_kernel",
        lambda: sum(t["thread"] for t in gj_real.K2_TIERS.values()))
    put("mc_tran_nr_kernel", lambda: sum(mc_tran_fused.K9_FORMS.values()))
    return out


def delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}
