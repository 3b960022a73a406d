"""What both drivers share: the program's environment and configuration
from a configuration file, the device's clock and peak, and the
reference's FLOP count."""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Callable, Dict

import torch

from benchmark.reference import npz
from benchmark.reference.upflow import Numerics


def program_config(config: Dict[str, Any]):
    """The port's ``UPFlowConfig`` of a configuration file, with the
    environment it states set for the program."""
    for key, value in config.get("program_env", {}).items():
        os.environ[key] = value
    from upflow_pytorch_tpu_torch.config import UPFlowConfig

    return UPFlowConfig().updated(config["upflow"])


def numerics(config: Dict[str, Any], quant=None) -> Numerics:
    return Numerics(quant, float(config["mask_threshold"]))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Stopwatch:
    """Splits the set-up into named parts."""

    def __init__(self, parts: Dict[str, float]):
        self.parts, self.t = parts, time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def meta_params(weights: str) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, device="meta")
            for k, v in npz.load_params(weights, "cpu").items()}


def count_flops(fn: Callable[[], Any]) -> float:
    """Conv and matrix-product FLOPs (two a multiply-add) of ``fn``, run on
    meta tensors, as torch's FlopCounterMode counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
