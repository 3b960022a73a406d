"""The port's ``Trainer`` on the CPU: the JAX package's end-to-end scenario
(``tests/test_trainer_e2e.py``: train one epoch with its evaluation and
checkpoint, resume in a fresh trainer, go on), a resumed run against an
uninterrupted one bit for bit (the loader is keyed on ``(seed, epoch,
index)``, the equivariance draw on the step, and CPU sums are ordered),
the equivariance pass's student forward pinning full-fp32 matrix
products, ``data_axis`` above 1 refused without a process group (the
data-parallel Trainer runs in ``test_torch_port_parallel.py``), and
``load_pretrained``'s report.  The
equivariance step's numbers against JAX's ``loss_fn`` are held in
``test_torch_port_equivariance.py``, beside the pass, in one JAX
compile.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from upflow_pytorch_tpu_torch.checkpoint.state_io import latest_step
from upflow_pytorch_tpu_torch.checkpoint.torch_import import (
    params_to_torch_state_dict)
from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.eval.bench import EvalSample, EvaluationBench
from upflow_pytorch_tpu_torch.losses import equivariance as pe
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.train.trainer import Trainer

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
H, W, M = 32, 48, 8
# the knobs of tests/test_trainer_e2e.py
CONF = UPFlowConfig().updated(dict(
    if_use_cor_pytorch=True, if_sgu_upsample=False,
    if_use_boundary_warp=True))


class SyntheticDataset:
    """The JAX end-to-end test's pairs: a random image and its copy
    shifted by one pixel, with the raw frames and the crop's start."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        raw = rng.rand(H + 2 * M, W + 2 * M, 3).astype(np.float32)
        raw2 = np.roll(raw, 1, axis=1)
        return {"im1_raw": raw, "im2_raw": raw2,
                "im1": raw[M:M + H, M:M + W], "im2": raw2[M:M + H, M:M + W],
                "start": np.array([M, M], np.float32)}


def eval_bench(n=2):
    rng = np.random.RandomState(3)
    out = []
    for i in range(n):
        flow = rng.randn(1, H, W, 2).astype(np.float32)
        mask = np.ones((1, H, W, 1), np.float32)
        out.append(EvalSample(
            im1=rng.rand(1, H, W, 3).astype(np.float32),
            im2=rng.rand(1, H, W, 3).astype(np.float32),
            flow_occ=flow, mask_occ=mask, flow_noc=flow.copy(),
            mask_noc=mask, name="s%d" % i))
    return EvaluationBench(out)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs here are many small ops: on one thread they take the same
    time alone and do not stall on a loaded machine, where each op's
    parallel region waits for descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trainer_conf(exp_dir, **kw):
    return TrainerConfig(exp_dir=str(exp_dir), batchsize=2,
                         batch_per_epoch=2, batch_per_print=1,
                         num_workers=2, eq_loss_weight=0.1, **kw)


def params_of(trainer):
    return {n: p.detach().clone()
            for n, p in trainer.model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A (0 -> 2 with evaluation and checkpoint), run B (a fresh
    trainer in A's directory: resume, to 3, to 4) and run C (0 -> 4 in
    another directory)."""
    root = tmp_path_factory.mktemp("trainer")
    logs = {"a": [], "b": [], "c": []}
    a = Trainer(CONF, trainer_conf(root / "ab"), SyntheticDataset(),
                eval_bench(), log_fn=logs["a"].append, device="cpu")
    a.train(total_steps=2)
    a.loader.close()
    b = Trainer(CONF, trainer_conf(root / "ab"), SyntheticDataset(), None,
                log_fn=logs["b"].append, device="cpu")
    resumed = b.try_resume()
    cursor = b.loader.state()
    resumed_step = b.state.step
    b.train(total_steps=3)
    step3 = b.state.step
    b.train(total_steps=4)
    b.loader.close()
    c = Trainer(CONF, trainer_conf(root / "c"), SyntheticDataset(), None,
                log_fn=logs["c"].append, device="cpu")
    assert not c.try_resume()
    c.train(total_steps=4)
    c.loader.close()
    return dict(a=a, b=b, c=c, logs=logs, resumed=resumed, cursor=cursor,
                resumed_step=resumed_step, step3=step3)


def test_trainer_end_to_end_with_resume(runs):
    logs = runs["logs"]
    assert any(line.startswith("eval @2: EPE All=") for line in logs["a"])
    assert any("=== epoch 1 done" in line for line in logs["a"])
    assert latest_step(runs["a"].ckpt_dir) == 4  # B saved at 4 in A's dir
    assert runs["resumed"] and runs["resumed_step"] == 2
    # 8 items, 2 a batch: 4 batches a loader epoch, 2 consumed
    assert (runs["cursor"]["epoch"], runs["cursor"]["position"]) == (0, 2)
    assert "resumed from step 2" in logs["b"]
    assert runs["step3"] == 3 and runs["b"].state.step == 4
    step_lines = [line for line in logs["c"] if line.startswith("step ")]
    assert len(step_lines) == 4
    assert all(" eq=" in line and " loss=" in line for line in step_lines)


def test_resumed_run_equals_uninterrupted_run(runs):
    b, c = params_of(runs["b"]), params_of(runs["c"])
    assert all(torch.equal(b[n], c[n]) for n in c)
    a = params_of(runs["a"])
    assert not all(torch.equal(a[n], c[n]) for n in c)
    for key in ("ph", "sm", "eq", "loss"):
        last = {run: runs["logs"][run][-1] for run in ("b", "c")}
        assert [t for t in last["b"].split() if t.startswith(key + "=")] \
            == [t for t in last["c"].split() if t.startswith(key + "=")]


def test_eq_student_forward_pins_full_fp32_matmuls(monkeypatch):
    """The pass calls the model directly: its flow resizes run under
    ``fp32_numerics`` whatever the caller set, and the caller's setting
    reads the same afterwards."""
    import upflow_pytorch_tpu_torch.ops.resize as presize

    model = entry.build_model(CONF, device="cpu", weights=NPZ)
    rng = np.random.RandomState(1)
    batch = {k: rng.rand(1, H, W, 3).astype(np.float32)
             for k in ("im1", "im2")}
    teacher = {k: v for k, v in entry.forward(
        model, batch["im1"], batch["im2"]).items() if k != "flows"}
    want = pe.equivariance_pass(model, batch, teacher, pe.step_generator(0))
    seen = []
    resize = presize.resize_bilinear_align_corners

    def spy(x, out_hw, cols=None):
        seen.append(torch.get_float32_matmul_precision())
        return resize(x, out_hw, cols)

    monkeypatch.setattr(presize, "resize_bilinear_align_corners", spy)
    try:
        torch.set_float32_matmul_precision("high")
        got = pe.equivariance_pass(model, batch, teacher,
                                   pe.step_generator(0))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert len(seen) >= 5 and set(seen) == {"highest"}
    assert torch.equal(got, want)


def test_data_axis_other_than_one_raises(tmp_path):
    """``data_axis`` splits the global batch over a process group's ranks:
    a batch that does not split raises, and so does a Trainer with
    ``data_axis > 1`` in a process that joined no group."""
    conf = TrainerConfig(exp_dir=str(tmp_path), data_axis=2)
    assert conf.batchsize == 2
    with pytest.raises(ValueError, match="split evenly"):
        TrainerConfig().updated(dict(data_axis=4))
    with pytest.raises(ValueError, match="split evenly"):
        TrainerConfig(data_axis=0)
    with pytest.raises(RuntimeError, match="needs a process group"):
        Trainer(CONF, conf, SyntheticDataset(), device="cpu")


def test_trainer_needs_a_gpu_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CONF, trainer_conf(tmp_path), SyntheticDataset())


def test_load_pretrained_report(tmp_path):
    source = entry.build_model(CONF, device="cpu", weights=NPZ)
    sd = params_to_torch_state_dict(source)
    sd["unknown.module.weight"] = torch.zeros(2)
    sd["conv_1x1.0.0.bias"] = torch.zeros(5)
    path = str(tmp_path / "ref.pth")
    torch.save(sd, path, _use_new_zipfile_serialization=False)
    logs = []
    trainer = Trainer(CONF, trainer_conf(tmp_path), SyntheticDataset(),
                      log_fn=logs.append, device="cpu")
    report = trainer.load_pretrained(path)
    assert report["skipped"] == ["conv_1x1.0.0.bias", "unknown.module.weight"]
    assert len(report["loaded"]) == 59
    assert logs[-1] == "loaded 59 keys from %s" % path
    want = source.state_dict()
    for n, p in trainer.model.named_parameters():
        if n != "conv_1x1.0.0.bias":
            assert torch.equal(p.detach(), want[n]), n

