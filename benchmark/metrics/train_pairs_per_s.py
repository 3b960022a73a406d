"""Frame pairs trained in the window (batch x steps) over the window's
seconds."""


def read(run):
    return run.window.units / run.window.seconds
