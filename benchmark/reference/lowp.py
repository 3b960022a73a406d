"""The reference's control precisions: the nearest precision below the one
a configuration states.

- ``fp8``, for a bf16 configuration: each conv's input and weight scaled
  per tensor so that its largest magnitude is float8_e4m3's largest
  finite value, rounded to float8_e4m3, and scaled back (a per-tensor
  scaled fp8 product with fp32 sums).
- ``tf32``, for an fp32 configuration with TF32 off: the same fp32
  reference with cuDNN's and cuBLAS's TF32 switched on.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-12)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


# a control's name -> (the conv operands' rounding, TF32 on)
CONTROLS = {None: (None, False), "fp8": (fp8_e4m3, False),
            "tf32": (None, True)}
