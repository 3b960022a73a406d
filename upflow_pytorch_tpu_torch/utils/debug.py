"""Debug and introspection helpers.

Port of ``upflow_pytorch_tpu/utils/debug.py``.  ``check_tensor`` mirrors
the reference's de-facto profiler (``utils/tools.py:1677-1694``);
``count_params`` and ``cost_analysis`` replace its thop-based model-size
counter (``tools.py:1711-1715``): parameters counted over a module or a
state dict, and operations counted by ``torch.utils.flop_counter``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode


def _host(x: Any) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def check_tensor(x: Any, name: str = "") -> str:
    """Prints and returns shape, dtype and value statistics of a tensor or
    an array."""
    bf16 = torch.is_tensor(x) and x.dtype == torch.bfloat16
    x = _host(x)
    msg = ("%s shape=%s dtype=%s max=%.5f min=%.5f mean=%.5f sum=%.5f"
           % (name, x.shape, "bfloat16" if bf16 else x.dtype, x.max(),
              x.min(), x.mean(), x.sum()))
    print(msg)
    return msg


def count_params(params: Union[nn.Module, Mapping[str, Any]]) -> int:
    """Number of parameter values of a module, or of every tensor of a
    state dict."""
    if isinstance(params, nn.Module):
        tensors = list(params.parameters())
    else:
        tensors = list(params.values())
    return sum(int(np.prod(t.shape)) for t in tensors)


def cost_analysis(fn, *args) -> Dict[str, Optional[float]]:
    """Operations of one call of ``fn(*args)``, counted by PyTorch's
    ``FlopCounterMode`` over the aten operators it knows (convolutions,
    matrix products); the hand-written kernels, called through ctypes, and
    elementwise work are not counted, and no byte count exists (None)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": None}


def enable_nan_debugging() -> None:
    """Autograd's anomaly mode: a backward that produces NaN raises, with
    the forward operation that created it."""
    torch.autograd.set_detect_anomaly(True)
