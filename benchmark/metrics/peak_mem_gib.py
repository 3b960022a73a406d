"""The device's peak of allocated memory over the window (the peak is
reset after the warm-up), in GiB."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2 ** 30
