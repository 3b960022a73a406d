"""The port's kernel ops' share of their roofline in the traced slice:
the sum over their calls of each call's bound (the larger of its bytes
over HBM bandwidth and its operations over its type's peak, from
``benchmark/ops/<op>.py`` at the call's shapes) over the device seconds of
their kernels, in %.  Ops with no call or no kernel time found are left
out of both sums."""

from benchmark.core import peaks


def read(run):
    t = run.trace
    if t is None:
        return None
    ops = {op for op, _, _, _ in t.op_calls
           if t.op_device_s.get(op, 0.0) > 0}
    if not ops:
        return None
    bound = sum(peaks.bound_s(b, f, kind) for op, b, f, kind in t.op_calls
                if op in ops)
    return 100.0 * bound / sum(t.op_device_s[op] for op in ops)
