"""Running metric meters.

Port of ``upflow_pytorch_tpu/utils/meters.py``, the mirror of the
reference's ``tools.AverageMeter`` / ``tools.Avg_meter_ls``
(``utils/tools.py:282-324``).  The evaluation bench depends on their exact
semantics: per-image values averaged over images WEIGHTED BY batch size,
not pooled over pixels.
"""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, num: int = 1):
        self.val = val
        self.sum += val * num
        self.count += num
        self.avg = self.sum / self.count if self.count else 0.0


class AvgMeterGroup:
    """Named-meter registry (``Avg_meter_ls``)."""

    def __init__(self):
        self.meters = {}
        self.short_names = {}

    def update(self, name: str, val: float, num: int = 1, short_name=None):
        if name not in self.meters:
            self.meters[name] = AverageMeter()
            self.short_names[name] = short_name or name
        self.meters[name].update(val, num)

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def print_all_losses(self) -> str:
        return " ".join("%s=%.4f(%.4f)" % (self.short_names[n], m.val, m.avg)
                        for n, m in self.meters.items())
