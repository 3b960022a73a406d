"""Device milliseconds a step (``.train``) of the operations that the
profiler links to a host op under the program's spans ``upflow.rule.*``
(the kernel ops' gradient rules, each ``backward`` of the autograd
Functions of ``ops/kernels/``), in the traced slice.  None where the
program opens no such span."""


def _rule(ancestors):
    return any(a.startswith("upflow.rule.") for a in ancestors)


def read(run):
    t = run.trace
    if t is None or not any(_rule(anc) for _, _, anc in t.launched):
        return None
    return t.device_s(_rule) / t.units * 1e3
