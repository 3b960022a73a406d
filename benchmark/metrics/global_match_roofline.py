"""GMFlow's global matching kernel's share of its roofline in the traced
slice, in %: the sum over its calls of each call's bound (the larger of
its bytes over HBM bandwidth and its q k^T products over the bf16 peak,
from ``benchmark/ops/global_match.py`` at the call's shapes) over the
device seconds of its kernel.  None where the program makes no such call
or its kernel is not found."""

from benchmark.core import peaks

OP = "global_match"


def read(run):
    t = run.trace
    if t is None or t.op_device_s.get(OP, 0.0) <= 0:
        return None
    calls = [(b, f, kind) for op, b, f, kind in t.op_calls if op == OP]
    if not calls:
        return None
    bound = sum(peaks.bound_s(b, f, kind) for b, f, kind in calls)
    return 100.0 * bound / t.op_device_s[OP]
