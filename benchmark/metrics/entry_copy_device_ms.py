"""Device milliseconds a pair (``.serve``, ``.serve_b1``) of the operations
(copies, kernels, memsets) that the profiler links to a host op under the
program's spans ``upflow.copy_in`` (the entry's host-to-device copy of the
images and their NCHW layout) or ``upflow.copy_out`` (the NHWC outputs),
in the traced slice.  None where the program opens neither span."""

COPIES = ("upflow.copy_in", "upflow.copy_out")


def _copy(ancestors):
    return any(a in COPIES for a in ancestors)


def read(run):
    t = run.trace
    if t is None or not any(_copy(anc) for _, _, anc in t.launched):
        return None
    return t.device_s(_copy) / t.units * 1e3
