"""The host's milliseconds from a call of the entry or the step to its
return, before the synchronise or the read of its metrics, as the mean
over the window's calls (``.serve``, ``.serve_b1``: requests; ``.train``:
steps)."""


def read(run):
    if not run.window.enqueue_s:
        return None
    return sum(run.window.enqueue_s) / len(run.window.enqueue_s) * 1e3
