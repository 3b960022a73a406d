"""Device operations a request (``.serve_b1``) that the profiler links to
a host op under the program's span ``upflow.forward`` (the entry): every
kernel, copy and memset, the kernel ops' launches through the C library
included, in the traced slice.  None where the program opens no such
span."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for _, _, anc in t.launched if "upflow.forward" in anc)
    return n / t.calls if n else None
