"""Device milliseconds a pair (``.gmflow_b1``) of the operations that the
profiler links to a host op under the program's spans
``upflow.gmflow.match`` and ``upflow.gmflow.propagate`` (GMFlow's global
softmax matching and flow propagation: the kernel calls, the grid's
subtraction and the propagation's projections), in the traced slice.
None where the program opens neither span."""

SPANS = ("upflow.gmflow.match", "upflow.gmflow.propagate")


def _under(anc):
    return any(s in anc for s in SPANS)


def read(run):
    t = run.trace
    if t is None or not any(_under(anc) for _, _, anc in t.launched):
        return None
    return t.device_s(_under) / t.units * 1e3
