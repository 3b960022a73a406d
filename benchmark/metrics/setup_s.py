"""Seconds from the process's start to the first timed call: imports, the
kernel library, the weights, the inputs and the warm-up of the cell's
shapes (the runner prints the parts)."""


def read(run):
    return run.setup_s
