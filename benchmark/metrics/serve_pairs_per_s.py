"""Frame pairs served in the window over the window's seconds."""


def read(run):
    return run.window.units / run.window.seconds
