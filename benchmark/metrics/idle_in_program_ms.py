"""The device's idle milliseconds a call (``.serve_b1``: a request;
``.train``: a step) in the gaps whose label is one of the program's spans
(``upflow.*``): the latest-started host op still open when the gap began
was the span itself, so the host was in the port's own Python, not in a
torch op or a CUDA call.  Read from the traced slice that records host
ops, whose host the profiler slows: the gaps there are longer than in the
window.  None where no gap carries such a label."""


def read(run):
    t = run.trace
    if t is None:
        return None
    idle = [s for label, s in t.gaps.items() if label.startswith("upflow.")]
    return sum(idle) / t.calls * 1e3 if idle else None
