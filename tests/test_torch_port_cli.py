"""The port's three dataset CLIs and its demo on the CPU, over small
synthetic KITTI and Sintel trees (``scripts/torch_synthetic_trees.py``).

``scripts/torch_kitti_eval.py`` with a ``.pth`` written from the trained
snapshot (``assets/synthetic_trained.npz``) is held against the JAX
package's bench (its ``KittiFlowEvalDataset``, ``EvaluationBench`` and
``NetEvalModel``) on the same tree, both at mask threshold 0.9999 as
``test_torch_port_eval.py`` runs them; its ``--state-ckpt``,
``--save-dir`` and test-split paths are checked against the port itself.
The training CLIs take a few steps from that ``.pth`` with a checkpoint
and a resume.  Every entry point raises without a card unless the CPU is
asked for.
"""

import functools
import sys
from pathlib import Path

import flax
import numpy as np
import pytest
import torch

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.data import kitti as jkitti
from upflow_pytorch_tpu.eval import bench as jbench
from upflow_pytorch_tpu.models import upflow as jupflow
from upflow_pytorch_tpu.train.trainer import NetEvalModel as JaxNetEvalModel

import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch import demo
from upflow_pytorch_tpu_torch.checkpoint import state_io, torch_import
from upflow_pytorch_tpu_torch.data import kitti
from upflow_pytorch_tpu_torch.data.flow_io import write_flow_png
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.train.trainer import NetEvalModel

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
sys.path.insert(0, str(ROOT / "scripts"))
import torch_kitti_eval  # noqa: E402
import torch_synthetic_trees as trees  # noqa: E402
import torch_train_kitti  # noqa: E402
import torch_train_sintel  # noqa: E402

RELAXED_THRESHOLD = 0.9999
BAR = 1e-3  # px (and F1 points) between the port's and JAX's bench
SMALL_TREES = dict(KITTI_2015_SIZES=((56, 120), (57, 123)),
                   PAIRS_PER_SIZE=1, TEST_SIZES=((56, 120),),
                   KITTI_2012_SIZE=(56, 120), MV_SIZE=(48, 100),
                   MV_FRAMES=14, SINTEL_SIZE=(52, 90))
MV_CROP, MV_RHO = (32, 64), 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The small trees, the trained snapshot as a reference ``.pth``, and
    the JAX package's eval recipe with the snapshot's parameters."""
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "trees"
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL_TREES.items():
            mp.setattr(trees, name, value)
        trees.write_trees(str(root), seed=5, workers=4)
    model = entry.build_model(torch_kitti_eval.EVAL_CONF, device="cpu",
                              weights=NPZ)
    pth = tmp / "snapshot.pth"
    torch.save(torch_import.params_to_torch_state_dict(model), pth)
    return dict(root=str(root), pth=str(pth), tmp=tmp, model=model)


@pytest.fixture()
def relaxed(monkeypatch):
    monkeypatch.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
    monkeypatch.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)


def _jax_bench(root, split):
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    conf = JaxConfig().updated(dict(torch_kitti_eval.EVAL_CONF.get_dict()))
    model = jupflow.build_model(conf)
    return jbench.EvaluationBench(jkitti.KittiFlowEvalDataset(root, split))(
        JaxNetEvalModel(model, params))


def test_kitti_eval_cli_matches_jax_bench(setup, relaxed, capsys):
    """Native-size evaluation of two frame sizes (one odd width) through
    the CLI: every metric within 1e-3 of the JAX bench's."""
    res = torch_kitti_eval.main(["--data-root", setup["root"], "--ckpt",
                                 setup["pth"], "--device", "cpu"])
    ref = _jax_bench(setup["root"], "2015_train")
    assert np.isfinite(res).all() and 0.0 < res.epe_all < 5.0
    np.testing.assert_allclose(res, ref, rtol=0, atol=BAR)
    out = capsys.readouterr().out
    assert "loaded 80 keys, skipped 0" in out
    assert ("EPE All = %.2f, F1 = %.2f" % (res.epe_all, res.f1)) in out


def test_kitti_eval_cli_state_ckpt_and_padding(setup, relaxed):
    """``--state-ckpt`` restores a trainer checkpoint's model: the same
    result as the ``.pth``; ``--pad-multiple 64`` runs the same pairs at
    64 x 128 and moves the result a little."""
    ckpt = setup["tmp"] / "ckpts"
    state_io.save_checkpoint(str(ckpt), 7,
                             {"model": setup["model"].state_dict()})
    base = ["--data-root", setup["root"], "--device", "cpu"]
    via_pth = torch_kitti_eval.main(base + ["--ckpt", setup["pth"]])
    via_state = torch_kitti_eval.main(base + ["--state-ckpt", str(ckpt)])
    assert via_state == via_pth
    padded = torch_kitti_eval.main(base + ["--ckpt", setup["pth"],
                                           "--pad-multiple", "64"])
    assert padded != via_pth
    assert abs(padded.epe_all - via_pth.epe_all) < 0.5


@pytest.mark.parametrize("split", ["2015_test", "2012_train"])
def test_kitti_eval_cli_save_dir(setup, split, tmp_path):
    """``--save-dir`` writes one KITTI flow PNG a pair, equal to the
    prediction as ``write_flow_png`` writes it; the test split prints no
    metrics."""
    save = tmp_path / "out"
    res = torch_kitti_eval.main(["--data-root", setup["root"], "--split",
                                 split, "--ckpt", setup["pth"],
                                 "--save-dir", str(save), "--device", "cpu"])
    dataset = kitti.KittiFlowEvalDataset(setup["root"], split)
    files = sorted(save.iterdir())
    assert len(files) == len(dataset)
    assert (res is None) == split.endswith("_test")
    eval_model = NetEvalModel(setup["model"])
    for sample, path in zip(dataset, files):
        if res is None:
            assert path.name == sample.name + ".png"
        flow = eval_model.eval_forward(sample.im1, sample.im2, 0)[0]
        write_flow_png(str(tmp_path / "want.png"), flow)
        assert path.read_bytes() == (tmp_path / "want.png").read_bytes()


def test_train_kitti_cli_resumes(setup, monkeypatch, tmp_path, capsys):
    """Two steps from the ``.pth`` (an epoch: evaluation and a checkpoint),
    then ``--resume`` for one more: finite losses, the step restored."""
    monkeypatch.setattr(torch_train_kitti, "KittiMultiviewDataset",
                        functools.partial(kitti.KittiMultiviewDataset,
                                          crop_size=MV_CROP, rho=MV_RHO))
    base = ["--mv-root", setup["root"], "--eval-root", setup["root"],
            "--exp-dir", str(tmp_path), "--batch", "2",
            "--batch-per-epoch", "2", "--device", "cpu"]
    first = torch_train_kitti.main(base + ["--pretrained", setup["pth"],
                                           "--steps", "2"])
    assert first.state.step == 2
    assert state_io.latest_step(first.ckpt_dir) == 2
    logs = capsys.readouterr().out.splitlines()
    assert any(line.startswith("loaded 80 keys") for line in logs)
    assert any(line.startswith("eval @2: EPE All=") for line in logs)
    second = torch_train_kitti.main(base + ["--resume", "--steps", "3"])
    assert second.state.step == 3
    assert "resumed from step 2" in capsys.readouterr().out.splitlines()
    for trainer in (first, second):
        assert trainer.meters.meters
        assert all(np.isfinite(m.avg) for m in trainer.meters.meters.values())
    assert not second.loader._thread.is_alive()


def test_train_sintel_cli_steps(setup, tmp_path, capsys):
    trainer = torch_train_sintel.main([
        "--root", setup["root"], "--exp-dir", str(tmp_path), "--batch", "2",
        "--crop", "32", "64", "--steps", "1", "--pretrained", setup["pth"],
        "--device", "cpu"])
    assert trainer.state.step == 1
    assert trainer.loader.dataset.crop_size == (32, 64)
    assert all(np.isfinite(m.avg) for m in trainer.meters.meters.values())
    assert "loaded 80 keys" in capsys.readouterr().out


@pytest.mark.parametrize("cli", ["kitti_eval", "train_kitti", "train_sintel",
                                 "demo"])
def test_entry_points_need_the_card(setup, cli, monkeypatch, tmp_path):
    """Without a card and without ``--device cpu`` every entry point
    raises; ``--data-axis`` above 1 raises outside torchrun (no process
    group to join; the two-rank run is in
    ``test_torch_port_parallel.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = setup["root"]
    argv = {"kitti_eval": (torch_kitti_eval.main, ["--data-root", root]),
            "train_kitti": (torch_train_kitti.main,
                            ["--mv-root", root, "--exp-dir", str(tmp_path)]),
            "train_sintel": (torch_train_sintel.main,
                             ["--root", root, "--exp-dir", str(tmp_path)]),
            "demo": (demo.main, ["--size", "64"])}
    main, args = argv[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    if cli.startswith("train"):
        for key in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(key, raising=False)
        with pytest.raises(RuntimeError, match="torchrun"):
            main(args + ["--data-axis", "2", "--device", "cpu"])


def test_demo_runs_on_the_cpu(capsys):
    out = demo.main(["--size", "64", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "params: 3494549" in printed
    for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw", "im1_warp",
                "im2_warp"):
        assert ("%s shape=" % key) in printed
        assert torch.isfinite(out[key]).all()
    assert out["flow_f_out"].shape == (1, 64, 64, 2)
    for key in ("smooth_loss", "photo_loss", "census_loss", "msd_loss",
                "total_loss"):
        assert np.isfinite(float(out[key])), key
