"""Profiling and tracing hooks.

Port of ``upflow_pytorch_tpu/utils/profiling.py``.  The reference's only
instrumentation is wall-clock prints (``tools.time_clock``,
``utils/tools.py:327-348``) and thop parameter counting.  Here:

- ``trace(log_dir)``: a ``torch.profiler`` context (host and, with a
  card, device activity) that writes a Chrome trace, viewable in
  Perfetto or ``chrome://tracing``;
- ``time_jitted``: the latency of a callable after warm-up calls, by CUDA
  events when it runs on the card and by ``time.perf_counter`` on the
  CPU;
- ``flops_of``: operations counted by ``torch.utils.flop_counter``.

The JAX module's ``start_server`` (a ``jax.profiler`` server for
on-demand capture) has no PyTorch counterpart and is left out.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profiles the block and writes ``log_dir/trace.json`` (Chrome trace
    format); yields the profiler, whose ``key_averages()`` sum it by
    operator and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _tensors(x: Any) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def time_jitted(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                force_transfer: bool = True) -> Dict[str, float]:
    """Latency of ``fn(*args)`` over ``iters`` calls after ``warmup``
    calls: best, median and mean seconds.

    Where the arguments or the warm-up's result hold a CUDA tensor, each
    call is timed by CUDA events recorded on the current stream and waited
    for, so the time is the device's up to the call's last kernel;
    otherwise by ``time.perf_counter``.  With ``force_transfer`` each call
    also sums its result's tensors into a host number inside the timed
    window, as the JAX function pulls a scalar to the host."""
    def run():
        out = fn(*args)
        if force_transfer:
            return sum(float(t.detach().float().sum())
                       for t in _tensors(out))
        return out

    out = None
    for _ in range(warmup):
        out = fn(*args)
    on_card = any(t.is_cuda for t in _tensors(args) + _tensors(out))
    times = []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    times.sort()
    return {"best_s": times[0], "median_s": times[len(times) // 2],
            "mean_s": sum(times) / len(times)}


def flops_of(fn: Callable, *args) -> Optional[float]:
    """Operations of one call of ``fn(*args)`` by ``FlopCounterMode`` (the
    aten operators it knows; the hand-written kernels are not counted);
    None when it counted none."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops else None
