"""Device milliseconds a pair (``.raft_b1``) of the operations that the
profiler links to a host op under the program's span
``upflow.raft.corr_volume`` (RAFT's all-pairs volume: its matrix products
and the pooling of its levels), in the traced slice.  None where the
program opens no such span."""

SPAN = "upflow.raft.corr_volume"


def read(run):
    t = run.trace
    if t is None or not any(SPAN in anc for _, _, anc in t.launched):
        return None
    return t.device_s(lambda anc: SPAN in anc) / t.units * 1e3
