"""Device milliseconds a pair (``.gmflow_b1``) of the operations that the
profiler links to a host op under the program's span
``upflow.gmflow.transformer`` (GMFlow's position code and its 6 blocks of
window attention, projections and feed-forward layers), in the traced
slice.  None where the program opens no such span."""

SPAN = "upflow.gmflow.transformer"


def read(run):
    t = run.trace
    if t is None or not any(SPAN in anc for _, _, anc in t.launched):
        return None
    return t.device_s(lambda anc: SPAN in anc) / t.units * 1e3
