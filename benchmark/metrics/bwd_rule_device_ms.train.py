"""Device milliseconds a step of the kernels launched inside the backward
of the program's autograd Functions (the kernel ops' gradient rules,
ranged ``bench_bwd::<Function>``), in the traced slice."""


def _rule(ancestors):
    return any(a.startswith("bench_bwd::") for a in ancestors)


def read(run):
    t = run.trace
    if t is None or not t.launched:
        return None
    ms = t.device_s(_rule) / t.units * 1e3
    return ms if ms > 0 else None
