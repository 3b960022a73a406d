"""The whole step's share of the chip's peak (``.serve``, ``.serve_b1``,
``.train``): the reference's conv and matrix-product FLOPs a pair (torch's
FlopCounterMode on meta tensors at the cell's shapes, forward for serving,
forward and backward for training, the same whatever implements them)
times the pairs of the window, over the window's seconds and the peak of the
configuration's precision, in %."""

from benchmark.core import peaks


def read(run):
    if not run.flops_per_unit:
        return None
    rate = run.flops_per_unit * run.window.units / run.window.seconds
    return 100.0 * rate / peaks.FLOPS_PER_S[run.config["precision"]]
