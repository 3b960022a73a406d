"""The port's checkpoints, ``.pth`` import and ``.npz`` export against the
JAX package's, on the CPU.

- ``checkpoint/state_io.py``: round trip, ``max_to_keep``, the newest
  step, a missing checkpoint raising ``FileNotFoundError``;
- ``load_torch_state_dict`` (``torch.load(weights_only=True)``) against
  the JAX package's torch-free reader, bit for bit, on the zip and legacy
  formats, shared storages and views, and a stream whose persistent ids
  carry torch 1.1's view metadata and storage class; tar containers and
  blocked globals refused;
- the relaxed and strict merges: the same reports as JAX's
  ``torch_state_dict_to_params`` on the same dict, and the same errors;
- a forward after the import against the JAX forward with the JAX-merged
  parameters (mask threshold 0.9999 on both sides, the bars of
  ``test_torch_port_model.py``: flows within 1e-4 px, occlusion bits on
  more than 99.9% of pixels);
- ``save_params_npz`` read by the JAX package's strict
  ``load_params_npz``.
"""

import io
import os
import pickle
import struct
import tarfile
import zipfile
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.checkpoint import npz_io as jnpz
from upflow_pytorch_tpu.checkpoint import torch_import as jti
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.models import upflow as jupflow

import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.checkpoint import npz_io as pnpz
from upflow_pytorch_tpu_torch.checkpoint import state_io
from upflow_pytorch_tpu_torch.checkpoint import torch_import as pti
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models import entry

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
KNOBS = dict(if_norm_before_cost_volume=True,
             norm_moments_across_channels=False,
             norm_moments_across_images=False, if_sgu_upsample=True)
RELAXED_THRESHOLD = 0.9999


@pytest.fixture(scope="module")
def jax_params():
    with np.load(NPZ) as z:
        return flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})


@pytest.fixture(scope="module")
def reference_sd(jax_params):
    """The checkpoint under the reference's keys, as torch tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jti.params_to_torch_state_dict(jax_params).items()}


def _model(sgu=True, seed=7):
    return entry.build_model(
        UPFlowConfig().updated(dict(KNOBS, if_sgu_upsample=sgu)),
        device="cpu", seed=seed)


# --- state_io -------------------------------------------------------------

def test_state_io_round_trip_and_max_to_keep(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    assert state_io.latest_step(ckpt) is None
    for step in (2, 4, 6, 8):
        state_io.save_checkpoint(ckpt, step, {
            "model": {"w": torch.full((3,), float(step))},
            "step": step, "loader": {"epoch": step // 4, "position": 1}},
            max_to_keep=3)
    assert sorted(os.listdir(ckpt)) == ["step_4.pt", "step_6.pt",
                                        "step_8.pt"]
    assert state_io.latest_step(ckpt) == 8
    got = state_io.restore_checkpoint(ckpt, map_location="cpu")
    assert got["step"] == 8 and got["loader"] == {"epoch": 2, "position": 1}
    assert torch.equal(got["model"]["w"], torch.full((3,), 8.0))
    assert state_io.restore_checkpoint(ckpt, 4, "cpu")["step"] == 4


@pytest.mark.parametrize("step", [None, 3])
def test_missing_checkpoint_raises(tmp_path, step):
    ckpt = str(tmp_path / "ckpts")
    if step is not None:
        state_io.save_checkpoint(ckpt, 2, {"step": 2})
    with pytest.raises(FileNotFoundError):
        state_io.restore_checkpoint(ckpt, step, map_location="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    state_io.save_checkpoint(str(tmp_path), 1, {"step": 1})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_io.restore_checkpoint(str(tmp_path))


# --- the .pth reader ------------------------------------------------------

def _view_metadata_stream(path):
    """A legacy stream as torch 1.1 wrote one for tensors that share
    slices of one storage: the persistent ids carry the storage class
    (``torch.FloatStorage``) and ``(view_key, element_offset, numel)``."""
    import torch._utils as tu

    root = np.arange(12, dtype=np.float32)
    root_pid = ("storage", torch.FloatStorage, "0", "cpu", 12, None)
    view_pid = ("storage", torch.FloatStorage, "0", "cpu", 12,
                ("0_view", 4, 6))

    class Pid:
        def __init__(self, pid):
            self.pid = pid

    class Tensor:
        def __init__(self, pid, size, stride):
            self.pid, self.size, self.stride = pid, size, stride

        def __reduce__(self):
            return (tu._rebuild_tensor_v2,
                    (Pid(self.pid), 0, self.size, self.stride, False,
                     __import__("collections").OrderedDict()))

    class Pickler(pickle.Pickler):
        def persistent_id(self, obj):
            return obj.pid if isinstance(obj, Pid) else None

    buf = io.BytesIO()
    for header in (0x1950A86A20F9469CFC6C, 1001,
                   {"protocol_version": 1001, "little_endian": True,
                    "type_sizes": {"short": 2, "int": 4, "long": 4}}):
        pickle.dump(header, buf, protocol=2)
    Pickler(buf, protocol=2).dump({
        "full": Tensor(root_pid, (3, 4), (4, 1)),
        "view": Tensor(view_pid, (2, 3), (3, 1))})
    pickle.dump(["0"], buf, protocol=2)
    buf.write(struct.pack("<q", 12))
    buf.write(root.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return {"full": root.reshape(3, 4), "view": root[4:10].reshape(2, 3)}


def _write(kind, path, reference_sd):
    """Writes one ``.pth`` of the given kind; returns its expected
    content."""
    if kind in ("zip", "legacy"):
        torch.save(reference_sd, path,
                   _use_new_zipfile_serialization=kind == "zip")
        return {k: v.numpy() for k, v in reference_sd.items()}
    if kind == "views":
        base = torch.arange(24, dtype=torch.float32)
        sd = {"a": base.view(4, 6), "b": base.view(4, 6),
              "c": base[6:18].view(3, 4), "d": base.view(4, 6).t(),
              "e": torch.arange(10, dtype=torch.int64)}
        torch.save(sd, path, _use_new_zipfile_serialization=False)
        return {k: v.numpy() for k, v in sd.items()}
    return _view_metadata_stream(path)


@pytest.mark.parametrize("kind", ["zip", "legacy", "views",
                                  "view-metadata"])
def test_reader_matches_jax_reader(kind, tmp_path, reference_sd):
    path = str(tmp_path / ("%s.pth" % kind))
    want = _write(kind, path, reference_sd)
    got = pti.load_torch_state_dict(path)
    ref = jti.load_torch_state_dict(path)
    assert list(got) == list(ref) and set(got) == set(want)
    for k in want:
        a = got[k].numpy()
        assert a.dtype == ref[k].dtype and a.shape == ref[k].shape, k
        assert a.tobytes() == np.ascontiguousarray(ref[k]).tobytes(), k
        assert np.array_equal(a, want[k]), k


def test_tar_container_rejected(tmp_path):
    path = str(tmp_path / "old.pth")
    with tarfile.open(path, "w") as tar:
        for name in ("pickle", "storages", "tensors"):
            data = pickle.dumps({})
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    for reader in (pti.load_torch_state_dict, jti.load_torch_state_dict):
        with pytest.raises(NotImplementedError, match="tar"):
            reader(path)


def test_blocked_globals_rejected(tmp_path):
    marker = tmp_path / "ran"

    class Evil:
        def __reduce__(self):
            return (os.system, ("touch %s" % marker,))

    path = str(tmp_path / "evil.pth")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", pickle.dumps({"x": Evil()}))
        zf.writestr("archive/version", "3\n")
    with pytest.raises(pickle.UnpicklingError):
        pti.load_torch_state_dict(path)
    assert not marker.exists()


# --- the merge ------------------------------------------------------------

def _edited(reference_sd, edit):
    sd = dict(reference_sd)
    if edit == "shape":
        sd["flow_estimators.conv1.0.weight"] = torch.zeros(1, 2, 3, 3)
    elif edit == "unknown":
        sd["unknown.module.weight"] = torch.zeros(4, 4, 3, 3)
        sd["flow_estimators.conv1.0.running_mean"] = torch.zeros(128)
    return sd


@pytest.mark.parametrize("sgu", [True, False], ids=["sgu", "no-sgu"])
@pytest.mark.parametrize("edit", ["none", "shape", "unknown"])
def test_merge_reports_match_jax(reference_sd, jax_params, edit, sgu):
    """Relaxed: the same loaded and skipped lists as JAX's merge (a model
    without SGU skips the SGU keys); strict: the same error, or none."""
    sd = _edited(reference_sd, edit)
    template = jax_params if sgu else {"params": {
        k: v for k, v in jax_params["params"].items()
        if not k.startswith("sgu_")}}
    model = _model(sgu)
    _, jreport = jti.torch_state_dict_to_params(
        {k: v.numpy() for k, v in sd.items()}, template, relaxed=True)
    report = pti.torch_state_dict_to_params(sd, model, relaxed=True)
    assert report == jreport
    assert len(report["loaded"]) == (80 if sgu else 60) - (edit == "shape")

    def strict(fn, *args):
        try:
            fn(*args, relaxed=False)
        except (KeyError, ValueError) as e:
            return type(e)
        return None

    assert strict(pti.torch_state_dict_to_params, sd, _model(sgu)) == \
        strict(jti.torch_state_dict_to_params,
               {k: v.numpy() for k, v in sd.items()}, template)


def test_merge_copies_in_place(reference_sd):
    model = _model()
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    report = pti.torch_state_dict_to_params(reference_sd, model)
    assert not report["skipped"]
    for n, p in model.named_parameters():
        assert p.data_ptr() == ptrs[n]
        assert torch.equal(p.detach(), reference_sd[n]), n
    assert pti.params_to_torch_state_dict(model).keys() == reference_sd.keys()


def test_forward_after_import_matches_jax(reference_sd, jax_params,
                                          tmp_path):
    path = str(tmp_path / "ref.pth")
    torch.save(reference_sd, path)
    zeros = jax.tree_util.tree_map(np.zeros_like, jax_params)
    merged, jreport = jti.load_pretrained_params(path, zeros)
    model = _model(seed=3)
    report = pti.load_pretrained_params(path, model)
    assert report == jreport and not report["skipped"]
    rng = np.random.RandomState(4)
    im1, im2 = (rng.rand(1, 64, 96, 3).astype(np.float32) for _ in range(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        jmodel = jupflow.build_model(JaxConfig().updated(KNOBS))
        ref = jax.jit(lambda p, a, b: jupflow.forward(jmodel, p, a, b))(
            merged, jnp.asarray(im1), jnp.asarray(im2))
        out = entry.forward(model, im1, im2)
    for key in ("flow_f_out", "flow_b_out"):
        err = float(np.abs(out[key].numpy() - np.asarray(ref[key])).max())
        assert err <= 1e-4, (key, err)
    for key in ("occ_fw", "occ_bw"):
        assert float(np.mean(out[key].numpy() != np.asarray(ref[key]))) \
            < 1e-3, key
    assert float(np.abs(np.asarray(ref["flow_f_out"])).mean()) > 0.1


def test_npz_snapshot_read_by_jax(jax_params, tmp_path):
    """A port-trained snapshot goes back to the JAX package: its strict
    reader takes every leaf, kernels in HWIO."""
    model = _model(seed=5)
    path = str(tmp_path / "port.npz")
    pnpz.save_params_npz(path, model)
    restored = jnpz.load_params_npz(path, jax_params)
    flat = flax.traverse_util.flatten_dict(restored, sep="/")
    back = entry.build_model(UPFlowConfig().updated(KNOBS), device="cpu",
                             weights=path)
    assert len(flat) == 80
    for n, p in model.named_parameters():
        assert torch.equal(back.state_dict()[n], p.detach()), n
    w = model.state_dict()["flow_estimators.conv1.0.weight"].numpy()
    np.testing.assert_array_equal(
        flat["params/flow_estimators/conv1/conv/kernel"],
        w.transpose(2, 3, 1, 0))
