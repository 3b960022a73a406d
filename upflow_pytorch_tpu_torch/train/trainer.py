"""Training harness of the port; for now its evaluation adapter.

``NetEvalModel`` is the port of
``upflow_pytorch_tpu/train/trainer.py::NetEvalModel``: the network seen
through the ``EvaluationBench`` contract (the reference's ``Eval_model``,
``scripts/simple_train.py:56-79``).  The trainer itself comes with the
training slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from upflow_pytorch_tpu_torch.eval.bench import AbsTestModel
from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet, forward


class NetEvalModel(AbsTestModel):
    """Adapter exposing the network to the ``EvaluationBench``.

    ``eval_forward`` runs ``models/upflow.py::forward`` on the model's
    device (the kernels on the card, their plain versions on the CPU) and
    returns the forward flow as NHWC numpy.  PyTorch runs eagerly, so
    every frame size is served as it comes and no compile cache is kept,
    unlike the JAX class's per-shape ``jit`` cache.

    ``pad_to_multiple=N`` edge-pads the frames (``np.pad(...,
    mode="edge")``) up to multiples of N and crops the flow back to
    (h, w), so every size of a dataset runs at a few padded shapes.  The
    padded output differs from native-size output near the padded border,
    so keep it off for strict parity runs.
    """

    def __init__(self, model: UPFlowNet,
                 pad_to_multiple: Optional[int] = None):
        self.model = model
        self.pad_to_multiple = pad_to_multiple

    def change_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Loads ``state_dict`` (strict) into the model."""
        self.model.load_state_dict(state_dict, strict=True)

    def eval_forward(self, im1, im2, gt, *args) -> np.ndarray:
        h, w = im1.shape[1:3]
        if self.pad_to_multiple:
            m = self.pad_to_multiple
            ph = -(-h // m) * m
            pw = -(-w // m) * m
            if (ph, pw) != (h, w):
                pad = ((0, 0), (0, ph - h), (0, pw - w), (0, 0))
                im1 = np.pad(np.asarray(im1), pad, mode="edge")
                im2 = np.pad(np.asarray(im2), pad, mode="edge")
        flow = forward(self.model, im1, im2)["flow_f_out"]
        return flow[:, :h, :w].cpu().numpy()

    def eval_save_result(self, save_name, predflow, *args, **kwargs):
        pass
