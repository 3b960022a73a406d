"""Training harness: the trainer and its evaluation adapter.

Port of ``upflow_pytorch_tpu/train/trainer.py``, the re-design of the
reference's ``Trainer`` and ``Loss_manager`` (``scripts/simple_train.py``):
an epoch loop over ``train/step.py``'s step with the per-epoch learning
rate, running loss meters, evaluation at every epoch's end through
``NetEvalModel`` and the ``EvaluationBench``, and step-tagged checkpoints
(``checkpoint/state_io.py``) of the model, the optimizer's state, the step
and the loader's cursor, from which ``try_resume`` continues a run, which
the reference cannot do.

With ``data_axis > 1``, or whenever a process group is initialised (one
process a card, e.g. under ``torchrun``; ``parallel/mesh.py``), the
trainer does what the JAX trainer's mesh calls do: it builds the mesh
over the group (whose size must equal ``data_axis``), replicates rank 0's
state, trains with the sharded step (``parallel/step.py``) on a loader
that decodes only this rank's slice of each global batch, and lets rank 0
alone log, evaluate and write checkpoints, the others waiting at a
barrier; ``try_resume`` restores the newest checkpoint on every rank.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from upflow_pytorch_tpu_torch.checkpoint.state_io import (
    latest_step, restore_checkpoint, save_checkpoint)
from upflow_pytorch_tpu_torch.checkpoint.torch_import import (
    load_pretrained_params)
from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.pipeline import DataLoader
from upflow_pytorch_tpu_torch.eval.bench import AbsTestModel, EvaluationBench
from upflow_pytorch_tpu_torch.models.entry import forward
from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet
from upflow_pytorch_tpu_torch.parallel.mesh import make_mesh, replicate
from upflow_pytorch_tpu_torch.train.step import (
    TrainState, create_train_state, make_train_step)
from upflow_pytorch_tpu_torch.utils.meters import AvgMeterGroup
from upflow_pytorch_tpu_torch.utils.timer import TimeClock

_LOSS_SHORT_NAMES = {
    "photo_loss": "ph",
    "smooth_loss": "sm",
    "census_loss": "cen",
    "msd_loss": "msd",
    "eq_loss": "eq",
    "total_loss": "loss",
}


class NetEvalModel(AbsTestModel):
    """Adapter exposing the network to the ``EvaluationBench``.

    ``eval_forward`` runs ``models/entry.py::forward`` on the model's
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


class Trainer:
    """The training loop over ``train_dataset`` (``__len__`` and
    ``__getitem__``, or ``item(index, epoch=)``), with ``eval_bench`` run
    at every epoch's end.  The model is built by ``create_train_state`` on
    ``device`` (the card unless ``"cpu"`` is asked for), from Kaiming-
    normal weights drawn from ``trainer_conf.seed`` or the ``.npz``
    snapshot ``weights``; batches reach it through the loader's device
    copy.  Under a process group the card is the current CUDA device, the
    one ``parallel/mesh.py::init_distributed`` sets (``make_mesh``)."""

    def __init__(self, model_conf: UPFlowConfig, trainer_conf: TrainerConfig,
                 train_dataset, eval_bench: Optional[EvaluationBench] = None,
                 log_fn: Callable[[str], None] = print, device=None,
                 weights: Optional[str] = None):
        self.model_conf = model_conf
        self.conf = trainer_conf
        self.mesh = None
        shard = (0, 1)
        if trainer_conf.data_axis > 1 or dist.is_initialized():
            self.mesh = make_mesh(data=trainer_conf.data_axis, device=device)
            device, shard = self.mesh.device, (self.mesh.rank, self.mesh.size)
        self.log = log_fn if self.is_writer else (lambda line: None)
        os.makedirs(trainer_conf.exp_dir, exist_ok=True)

        self.model, self.state, self.optimizer = create_train_state(
            model_conf, trainer_conf, device=device, weights=weights)
        self.device = next(self.model.parameters()).device
        if self.mesh is not None:
            replicate(self.mesh, self.model, self.optimizer)
        self.train_step = make_train_step(
            self.model, self.optimizer,
            eq_loss_weight=trainer_conf.eq_loss_weight,
            eq_loss_use_occ=trainer_conf.eq_loss_use_occ,
            eq_loss_type=trainer_conf.eq_loss_type, mesh=self.mesh)
        self.loader = DataLoader(
            train_dataset, batch_size=trainer_conf.batchsize,
            num_workers=trainer_conf.num_workers, shuffle=True,
            drop_last=True, seed=trainer_conf.seed, device=self.device,
            shard=shard)
        self.eval_bench = eval_bench
        self.meters = AvgMeterGroup()
        self.best_metric = float("inf")
        # one adapter over the trained model itself: its parameters are
        # updated in place, so evaluation always sees the current ones
        self._eval_model = NetEvalModel(
            self.model, pad_to_multiple=trainer_conf.eval_pad_to_multiple)

    @property
    def is_writer(self) -> bool:
        """Whether this process logs, evaluates and writes checkpoints:
        the only one, or rank 0 of the group."""
        return self.mesh is None or self.mesh.rank == 0

    # --- checkpoint/resume -------------------------------------------------
    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.conf.exp_dir, "ckpts")

    def save(self, step: int):
        payload = {"model": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict(),
                   "step": self.state.step,
                   "loader": self.loader.state()}
        save_checkpoint(self.ckpt_dir, step, payload)

    def try_resume(self) -> bool:
        """Restores the newest checkpoint (parameters, optimizer state,
        step, loader cursor), before ``train``, on every rank; False when
        there is none."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return False
        payload = restore_checkpoint(self.ckpt_dir, step,
                                     map_location=self.device)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.state = TrainState(self.state.params, self.optimizer.state,
                                int(payload["step"]))
        self.loader.set_cursor(int(payload["loader"]["epoch"]),
                               int(payload["loader"]["position"]))
        self.log("resumed from step %d" % step)
        return True

    def load_pretrained(self, pth_path: str) -> Dict[str, List[str]]:
        """Merges a reference ``.pth`` state dict into the model (relaxed,
        ``checkpoint/torch_import.py``) and returns the merge's report."""
        report = load_pretrained_params(pth_path, self.model)
        if self.mesh is not None:
            replicate(self.mesh, self.model)
        self.log("loaded %d keys from %s" % (len(report["loaded"]), pth_path))
        return report

    # --- loops --------------------------------------------------------------
    def train(self, total_steps: Optional[int] = None) -> TrainState:
        """Trains from the state's step up to ``total_steps`` (by default
        ``n_epoch * batch_per_epoch``)."""
        total = (total_steps if total_steps is not None
                 else self.conf.n_epoch * self.conf.batch_per_epoch)
        timer = TimeClock()
        timer.start()
        it = iter(self.loader)
        for i in range(self.state.step, total):
            batch = next(it)
            self.state, metrics = self.train_step(self.state, batch)
            for name, val in metrics.items():
                self.meters.update(name, float(val), self.conf.batchsize,
                                   _LOSS_SHORT_NAMES.get(name))
            step = i + 1
            if step % self.conf.batch_per_print == 0:
                self.log("step %d | %s" % (step,
                                           self.meters.print_all_losses()))
            if step % self.conf.batch_per_epoch == 0:
                timer.end()
                self.log("=== epoch %d done in %.2fs"
                         % (step // self.conf.batch_per_epoch,
                            timer.get_during()))
                self.evaluate_and_checkpoint(step)
                self.meters.reset()
                timer.start()
        return self.state

    def evaluate_and_checkpoint(self, step: int):
        if self.is_writer:
            self._evaluate_and_save(step)
        if self.mesh is not None:
            self.mesh.barrier()

    def _evaluate_and_save(self, step: int):
        if self.eval_bench is not None:
            res = self.eval_bench(self._eval_model)
            # padded-bucket metrics are approximate near the padded border
            # (tests/test_eval_padding.py); acceptance runs evaluate at
            # native size (eval_pad_to_multiple=None)
            approx = (" (pad=%d buckets, approximate)"
                      % self._eval_model.pad_to_multiple
                      if self._eval_model.pad_to_multiple else "")
            self.log("eval @%d: EPE All=%.2f F1=%.2f Noc=%.2f Occ=%.2f%s"
                     % (step, res.epe_all, res.f1, res.epe_noc, res.epe_occ,
                        approx))
            if res.epe_all < self.best_metric:
                self.best_metric = res.epe_all
        self.save(step)
