"""Device milliseconds a unit of the trace (``.serve``, ``.serve_b1``: a
pair; ``.train``: a step) of the kernels launched inside a convolution's
host range (the library convolutions and their autograd, whose op names hold
'convolution') and of the bf16 conv kernel ``conv3x3_seg`` (by its
name), in the traced slice."""


def _conv(ancestors):
    return any("convolution" in a.lower() for a in ancestors)


def read(run):
    t = run.trace
    if t is None or not t.launched:
        return None
    ms = (t.device_s(_conv) + t.op_device_s.get("conv3x3_seg", 0.0)
          ) / t.units * 1e3
    return ms if ms > 0 else None
