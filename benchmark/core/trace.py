"""Two short profiled slices of a run, reduced to what the per-layer metrics
and the result's ``breakdown`` read.  Each slice runs the same requests or
steps after the window.

The first is profiled with the device's activity alone: the profiler
records no host op, so the host keeps its own pace.

- ``busy_s``: the union of the device's kernel, copy and memset intervals;
  ``wall_s``: the slice's host clock, which ends in a synchronise.  The
  device's busy time a call, spread over the window's calls and seconds,
  gives its idle share over the window (the slice itself runs slower: the
  profiler still costs the host some microseconds a launch).

The second is profiled with host ops too, with the program's kernel ops'
calls recorded and its backward rules ranged (``instrument.py``):

- ``launched``: each device kernel that the profiler links to the host op
  that launched it, with its duration and the names of that op and its
  ancestors (among them the ranges ``bench_bwd::<Function>``), for
  attribution by range.
- ``by_name``: device seconds by kernel name; ``op_device_s``: device
  seconds of each op's kernels, matched by name (``KERNEL`` of
  ``benchmark/ops/<op>.py``): the profiler links no host range to a
  kernel that the program launches through its C library, so these are
  found by name until the program's own ranges say which op launched
  them.
- ``gaps``: the device's idle seconds summed by the host op that was
  running when each gap began (the latest-started host op still open
  then).
- ``op_calls``: each kernel op call's bytes, operations and their type.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark.core import instrument

GAP_LOOKBACK = 4000  # host events searched back for a gap's label


@dataclasses.dataclass
class Trace:
    wall_s: float  # the first slice's
    busy_s: float  # the first slice's
    calls: int  # requests or steps in each slice
    units: int  # pairs (serving) or steps (training) in each slice
    launched: List[Tuple[str, float, Tuple[str, ...]]]
    by_name: Dict[str, float]
    op_device_s: Dict[str, float]
    gaps: Dict[str, float]
    op_calls: List[Tuple[str, float, float, str]]  # op, bytes, flops, kind

    def device_s(self, under: Callable[[Tuple[str, ...]], bool]) -> float:
        """Device seconds of the kernels launched under host ops whose
        ancestry satisfies ``under``."""
        return sum(s for _, s, anc in self.launched if under(anc))

    def top_ops(self, n: int = 10) -> List[List]:
        return [[name[:160], s] for name, s in sorted(
            self.by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        return [[name[:160], s] for name, s in sorted(
            self.gaps.items(), key=lambda kv: -kv[1])[:n]]


def _annotation(e) -> bool:
    # the profiler mirrors host ranges on the device's timeline
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(("bench_", "ProfilerStep"))


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _split(events):
    """The device's operations and the host's events of a profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not _annotation(e):
                device.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    return device, host


def busy_seconds(events) -> float:
    """The union of the device's operation intervals, in seconds."""
    merged = _merge([(e.time_range.start, e.time_range.end)
                     for e in _split(events)[0]])
    return sum(e - s for s, e in merged) / 1e6


def reduce(events, busy_s: float, wall_s: float, calls: int, units: int,
           op_calls: Optional[list] = None,
           kernels: Optional[Dict[str, str]] = None) -> Trace:
    """The host-op slice's ``events`` reduced, with the device-only
    slice's ``busy_s`` and ``wall_s``."""
    device, host = _split(events)
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e6
    op_device_s = {op: sum(s for name, s in by_name.items()
                           if re.search(pattern, name))
                   for op, pattern in (kernels or {}).items()}
    merged = _merge([(e.time_range.start, e.time_range.end)
                     for e in device])

    launched = []
    for e in host:
        if not e.kernels:
            continue
        names, parent = [], e
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        anc = tuple(names)
        for k in e.kernels:
            launched.append((k.name, k.duration / 1e6, anc))

    gaps: Dict[str, float] = {}
    if merged and host:
        host.sort(key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in host]
        edges = [(min(starts[0], merged[0][0]), merged[0][0])]
        edges += [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        for s, e in edges:
            if e <= s:
                continue
            label = "host idle"
            i = bisect.bisect_right(starts, s) - 1
            for j in range(i, max(i - GAP_LOOKBACK, -1), -1):
                if host[j].time_range.end >= s:
                    label = host[j].name
                    break
            gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e6
    return Trace(wall_s, busy_s, calls, units, launched, by_name,
                 op_device_s, gaps, list(op_calls or []))


def _profiled(fn: Callable[[], int], device: torch.device, host: bool):
    """(events, host seconds, calls) of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        n = fn()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    return prof.events(), wall, n


def capture(fn: Callable[[], int], device: torch.device, ops: dict,
            package: str, per_call: int) -> Trace:
    """Profiles ``fn``, which runs some requests or steps and returns how
    many, in the two slices above; ``per_call`` is the units a call
    (pairs a request, or 1 a step)."""
    events, wall, n = _profiled(fn, device, host=False)
    busy = busy_seconds(events)
    op_calls: list = []
    with instrument.op_calls(ops, op_calls), \
            instrument.backward_ranges(package):
        events, _, _ = _profiled(fn, device, host=True)
    return reduce(events, busy, wall, n, n * per_call, op_calls,
                  instrument.kernels(ops))
