"""The device's idle share over the window (``.serve``, ``.serve_b1``,
``.train``), in %: one less the device's busy time a call, from the traced
slice profiled with the device's activity alone (the union of its kernel,
copy and memset intervals over the slice's calls), times the window's
calls, over the window's seconds.  The slice's own idle share reads higher: the
profiler's cost on each launch slows the host there."""


def read(run):
    t, w = run.trace, run.window
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.calls * w.calls / w.seconds)
