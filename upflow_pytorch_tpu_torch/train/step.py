"""The training step, PyTorch/CUDA.

Port of ``upflow_pytorch_tpu.train.step``.  The optimizer is the
reference recipe's ``Adam(lr, amsgrad=True, weight_decay)``: torch's own,
whose order (the running maximum of the raw second moment, bias-corrected
after it; the weight decay added to the gradient) is the one the JAX
package's ``scale_by_amsgrad_torch`` reproduces.  The learning rate is the
reference's per-epoch ``ExponentialLR`` as a staircase on the step count,
``lr * gamma ** (step // batch_per_epoch)`` (``learning_rate``).  With
``if_froze_pwc`` the PWC parameters (the pyramid, the flow estimator, the
context network and the 1x1 convs) take no gradient and no update.

``train_step(state, batch)`` runs ``forward_with_loss`` and its backward
under ``fp32_numerics`` and one optimizer step; the parameters and the
optimizer's state are updated in place, and the returned state counts the
step.  The whole step runs under ``deterministic_numerics``: torch's
deterministic algorithms in their strict form and cuDNN's deterministic
algorithms, so two runs from the same state give the same losses and
parameters bit for bit, on the card as on the CPU, as XLA's fixed order
of sums gives the JAX package.  With ``eq_loss_weight > 0`` the step adds
the equivariance pass (``losses/equivariance.py``): a student forward on
an affine transform of the pair, held against the detached teacher
outputs of the step's own forward, its transforms drawn from the step
count (``equivariance.step_generator``), so a resumed run draws the same
ones.

With a ``mesh`` (``parallel/step.py::make_sharded_train_step``) the batch
is this rank's slice of the global batch and the step computes what one
process computes on the global batch, as the JAX package's GSPMD step
does: the loss's normalisers are summed over the ranks
(``parallel/reduce.py``), the equivariance transforms are drawn at the
global batch's size and sliced, the gradients are averaged over the ranks
in one flat all-reduce before the optimizer's step, and the metrics are
averaged, so every rank reports the global loss.
"""

from __future__ import annotations

import contextlib
from typing import (Any, Dict, Iterable, Iterator, NamedTuple, Optional,
                    Tuple)

import torch
import torch.nn as nn

from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.losses.equivariance import (
    equivariance_pass, step_generator)
from upflow_pytorch_tpu_torch.models.entry import build_model
from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet, forward_with_loss
from upflow_pytorch_tpu_torch.ops.resize import fp32_numerics
from upflow_pytorch_tpu_torch.parallel.reduce import (
    average_gradients, average_metrics, global_normalisers)
from upflow_pytorch_tpu_torch.utils.profiling import span

# the modules frozen by if_froze_pwc (the reference's froze_PWC)
PWC_FROZEN_ROOTS = ("feature_pyramid_extractor", "flow_estimators",
                    "context_networks", "conv_1x1")
METRICS = ("photo_loss", "smooth_loss", "census_loss", "msd_loss")


@contextlib.contextmanager
def deterministic_numerics() -> Iterator[None]:
    """``torch.use_deterministic_algorithms(True)`` (strict: an op without
    a deterministic kernel raises) and ``cudnn.deterministic`` for the
    block, and the caller's three settings (enabled, warn-only, cuDNN's
    flag) restored after it, also when the block raises."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.deterministic = saved[2]


class TrainState(NamedTuple):
    params: Dict[str, nn.Parameter]  # the model's, updated in place
    opt_state: Dict[Any, Any]  # the optimizer's per-parameter state
    step: int


def pwc_frozen(name: str) -> bool:
    """Whether ``if_froze_pwc`` freezes the parameter of that name."""
    return name.split(".")[0] in PWC_FROZEN_ROOTS


def learning_rate(conf: TrainerConfig, step: int) -> float:
    """The learning rate of step ``step`` (counted from 0)."""
    return conf.lr * conf.scheduler_gamma ** (
        step // max(conf.batch_per_epoch, 1))


def make_optimizer(conf: TrainerConfig,
                   named_params: Iterable[Tuple[str, torch.Tensor]],
                   freeze_pwc: bool = False) -> torch.optim.Adam:
    """Adam with AMSGrad over the named parameters (the frozen ones left
    out with ``freeze_pwc``); ``set_learning_rate`` applies the schedule,
    which the optimizer keeps as ``optimizer.trainer_conf``."""
    params = [p for name, p in named_params
              if not (freeze_pwc and pwc_frozen(name))]
    optimizer = torch.optim.Adam(params, lr=conf.lr, amsgrad=True,
                                 weight_decay=conf.weight_decay)
    optimizer.trainer_conf = conf
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, step: int) -> None:
    lr = learning_rate(optimizer.trainer_conf, step)
    for group in optimizer.param_groups:
        group["lr"] = lr


def create_train_state(model_conf: UPFlowConfig,
                       trainer_conf: TrainerConfig = TrainerConfig(),
                       device=None, weights: Optional[str] = None,
                       seed: Optional[int] = None
                       ) -> Tuple[UPFlowNet, TrainState, torch.optim.Adam]:
    """The model on ``device`` (CUDA unless ``"cpu"`` is asked for), from
    the ``.npz`` snapshot ``weights`` or Kaiming-normal weights drawn from
    ``seed`` (``trainer_conf.seed`` by default), its optimizer, and the
    state at step 0."""
    seed = trainer_conf.seed if seed is None else seed
    model = build_model(model_conf, device, weights, seed)
    freeze = model_conf.if_froze_pwc
    for name, p in model.named_parameters():
        p.requires_grad_(not (freeze and pwc_frozen(name)))
    optimizer = make_optimizer(trainer_conf, model.named_parameters(),
                               freeze)
    return (model, TrainState(dict(model.named_parameters()),
                              optimizer.state, 0), optimizer)


def make_train_step(model: UPFlowNet, optimizer: torch.optim.Optimizer,
                    eq_loss_weight: float = 0.0,
                    eq_loss_use_occ: bool = True,
                    eq_loss_type: str = "abs_robust", mesh=None):
    """``train_step(state, batch) -> (state, metrics)``: one optimizer step
    on ``batch`` (``forward_with_loss``'s keys).  ``metrics`` holds the
    loss terms present (``photo_loss``, ``smooth_loss``, ``census_loss``,
    ``msd_loss``, and ``eq_loss`` with ``eq_loss_weight > 0``) and
    ``total_loss``, as detached 0-dim tensors.  With ``mesh``
    (``parallel/mesh.py``) ``batch`` is this rank's slice of the global
    batch and the metrics are the global batch's.  The step runs under
    ``deterministic_numerics``."""
    trainable = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with span("upflow.step"), deterministic_numerics():
            model.zero_grad(set_to_none=True)
            with (contextlib.nullcontext() if mesh is None
                  else global_normalisers(mesh)):
                with span("upflow.step.loss"):
                    out = forward_with_loss(model, batch)
                    metrics = {k: out[k].detach() for k in METRICS
                               if out[k] is not None}
                    total = out["total_loss"]
                if eq_loss_weight > 0:
                    with span("upflow.step.equivariance"):
                        eq = eq_loss_weight * equivariance_pass(
                            model, batch, out, step_generator(state.step),
                            use_occ=eq_loss_use_occ,
                            loss_type=eq_loss_type, mesh=mesh)
                        metrics["eq_loss"] = eq.detach()
                        total = total + eq
            with span("upflow.step.backward"), fp32_numerics():
                total.backward()
            if mesh is not None:
                average_gradients(mesh, trainable)
            with span("upflow.step.optimizer"):
                set_learning_rate(optimizer, state.step)
                optimizer.step()
            metrics["total_loss"] = total.detach()
            if mesh is not None:
                metrics = average_metrics(mesh, metrics)
        return TrainState(state.params, optimizer.state,
                          state.step + 1), metrics

    return train_step
