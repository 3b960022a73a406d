"""KITTI evaluation bench.

Port of ``upflow_pytorch_tpu/eval/bench.py``, the re-design of the
reference's ``kitti_flow.Evaluation_bench``
(``dataset/kitti_dataset.py:380-514``) around an abstract two-method
test-model contract (``tools.abs_test_model``, ``tools.py:157-164``).

Metric semantics preserved exactly: per-image EPE / F1 values averaged
over images (``AverageMeter`` weighted by batch size); EPE-occ uses the
occluded-area mask = occ_valid - noc_valid (``kitti_dataset.py:442-444``).

Works with any iterable of eval samples (NHWC numpy); the port's model
plugs in through ``train/trainer.py::NetEvalModel``.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional

import numpy as np

from upflow_pytorch_tpu_torch.eval.metrics import flow_error_avg, outlier_pct
from upflow_pytorch_tpu_torch.utils.meters import AverageMeter
from upflow_pytorch_tpu_torch.utils.timer import TimeClock


class AbsTestModel:
    """The reference's ``tools.abs_test_model`` contract
    (``tools.py:157-164``)."""

    def eval_forward(self, im1, im2, gt, *args):
        raise NotImplementedError

    def eval_save_result(self, save_name, predflow, *args, **kwargs):
        pass


class EvalSample(NamedTuple):
    """One eval item, NHWC numpy (batch dim 1 or more).

    Train splits carry GT; test splits carry ``name`` only.
    """

    im1: np.ndarray
    im2: np.ndarray
    flow_occ: Optional[np.ndarray] = None
    mask_occ: Optional[np.ndarray] = None
    flow_noc: Optional[np.ndarray] = None
    mask_noc: Optional[np.ndarray] = None
    name: str = ""


class BenchResult(NamedTuple):
    epe_all: float
    f1: float
    epe_noc: float
    epe_occ: float


class EvaluationBench:
    def __init__(self, dataset: Iterable[EvalSample],
                 is_test_split: bool = False, verbose: bool = False):
        self.dataset = dataset
        self.is_test_split = is_test_split
        self.verbose = verbose
        self.timer = TimeClock()

    def __call__(self, test_model: AbsTestModel) -> Optional[BenchResult]:
        if self.is_test_split:
            self.timer.start()
            for sample in self.dataset:
                pred = test_model.eval_forward(sample.im1, sample.im2, 0)
                test_model.eval_save_result(sample.name, pred)
            self.timer.end()
            if self.verbose:
                print("=== test time %ss ===" % self.timer.get_during())
            return None

        all_m = AverageMeter()
        f1_m = AverageMeter()
        occ_m = AverageMeter()
        noc_m = AverageMeter()
        self.timer.start()
        for index, s in enumerate(self.dataset):
            num = s.im1.shape[0]
            pred = np.asarray(test_model.eval_forward(
                s.im1, s.im2, s.flow_occ, s.mask_occ, s.flow_noc, s.mask_noc))

            all_m.update(flow_error_avg(s.flow_occ, pred, s.mask_occ), num)
            f1_m.update(outlier_pct(s.flow_occ, pred, s.mask_occ), num)
            noc_m.update(flow_error_avg(s.flow_noc, pred, s.mask_noc), num)
            occ_area = s.mask_occ - s.mask_noc
            occ_m.update(flow_error_avg(s.flow_occ, pred, occ_area), num)
            save_name = "all_%.2f f1_%.1f noc_%.2f occ_%.2f__%d" % (
                all_m.val, f1_m.val, noc_m.val, occ_m.val, index)
            test_model.eval_save_result(save_name, pred, occmask=s.mask_occ)
        self.timer.end()
        if self.verbose:
            print("=== eval time %ss ===" % self.timer.get_during())
        return BenchResult(all_m.avg, f1_m.avg, noc_m.avg, occ_m.avg)
