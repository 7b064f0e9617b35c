"""The reduction from a profiler trace of a few whole jobs to numbers.

The trace is ``torch.profiler`` with CUDA activity only: CUPTI's kernel,
copy and set records on the device, and the CUDA runtime calls on the
host (``cudaLaunchKernel``, ``cudaStreamSynchronize``, ...). The host's
own operator records are left out: on a job that makes 170k launches
they slow the host fourfold, and the idle share would read the
profiler's cost. Raw records are read (``kineto_results.events()``):
building the profiler's event tree over a million records takes a
minute.

- Busy time: the union of the device records' intervals (a kernel that
  overlaps a copy counts once).
- Device time by name: the sum of each name's records.
- Launches: the runtime's kernel-launch calls.
- Idle gaps: the intervals between busy spans, each named by the device
  record that ends it ("before <name>": the host was preparing that
  launch or copy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def short(name: str, width: int = 100) -> str:
    """A record's name cut to ``width`` characters on one line."""
    return " ".join(name.split())[:width]


@dataclass
class Trace:
    by_name: dict[str, list] = field(default_factory=dict)  # name -> [n, s]
    busy_s: float = 0.0
    launches: int = 0
    runtime: dict[str, int] = field(default_factory=dict)
    gaps: dict[str, float] = field(default_factory=dict)    # "before x" -> s

    def seconds(self, match) -> float:
        """Device seconds of the records whose name ``match`` accepts."""
        return sum(v[1] for n, v in self.by_name.items() if match(n))

    def count(self, match) -> int:
        return sum(v[0] for n, v in self.by_name.items() if match(n))

    def top(self, k: int = 10) -> list[list]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:k]
        return [[short(n), v[1]] for n, v in rows]

    def top_gaps(self, k: int = 10) -> list[list]:
        rows = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:k]
        return [[n, s] for n, s in rows]


def reduce(prof) -> Trace:
    """A ``torch.profiler.profile`` that has stopped -> Trace."""
    from torch.autograd import DeviceType

    tr = Trace()
    spans = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            dur = e.duration_ns()
            acc = tr.by_name.setdefault(name, [0, 0.0])
            acc[0] += 1
            acc[1] += dur * 1e-9
            spans.append((start, start + dur, name))
        else:
            tr.runtime[name] = tr.runtime.get(name, 0) + 1
            if name in LAUNCH_CALLS:
                tr.launches += 1
    spans.sort()
    busy = 0
    cur_s = cur_e = None
    for s, e, name in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                key = "before " + short(name, 80)
                tr.gaps[key] = tr.gaps.get(key, 0.0) + (s - cur_e) * 1e-9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    tr.busy_s = busy * 1e-9
    return tr
