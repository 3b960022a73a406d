"""The port's data layer against the JAX package's, on the CPU: the PNG,
KITTI flow PNG and ``.flo`` codecs, the native C++ decoder built by the
port, and the KITTI and Sintel datasets over small synthetic trees in the
exact KITTI and Sintel layouts (``scripts/torch_synthetic_trees.py``).

Inputs come from numpy seeds.  Files written by both packages must be
byte-equal, decodes equal, and dataset items equal bit for bit.  Rows
filtered by Sub, Average and Paeth (which ``write_png`` never writes)
come from ``encode_filtered_png`` below.  The native library is built in
a module fixture, so the tests collected never depend on whether it was
built before.
"""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from upflow_pytorch_tpu.data import flow_io as jflow_io
from upflow_pytorch_tpu.data import image_io as jimage_io
from upflow_pytorch_tpu.data import kitti as jkitti
from upflow_pytorch_tpu.data import native as jnative
from upflow_pytorch_tpu.data import pipeline as jpipe
from upflow_pytorch_tpu.data import sintel as jsintel

import upflow_pytorch_tpu_torch.data as pdata
from upflow_pytorch_tpu_torch.data import flow_io
from upflow_pytorch_tpu_torch.data import image_io
from upflow_pytorch_tpu_torch.data import kitti
from upflow_pytorch_tpu_torch.data import native
from upflow_pytorch_tpu_torch.data import pipeline
from upflow_pytorch_tpu_torch.data import sintel

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_synthetic_trees as trees  # noqa: E402

# small trees: two KITTI 2015 sizes (one odd width), multiview frames and
# Sintel frames large enough for the crops below
SMALL_TREES = dict(KITTI_2015_SIZES=((56, 120), (57, 123)),
                   TEST_SIZES=((56, 120), (57, 123)),
                   KITTI_2012_SIZE=(58, 118), MV_SIZE=(48, 100),
                   MV_FRAMES=16, SINTEL_SIZE=(52, 90))
MV_CROP, MV_RHO = (32, 64), 4
SINTEL_CROP = (32, 64)


def encode_filtered_png(path, img, filters=(1, 2, 3, 4)):
    """A PNG of ``img`` ((H, W, C) uint8 or uint16) whose row y is filtered
    by ``filters[y % len(filters)]`` (1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    bitdepth = 16 if img.dtype == np.uint16 else 8
    bpp = c * bitdepth // 8
    rows = np.frombuffer(img.astype(">u2" if bitdepth == 16 else np.uint8)
                         .tobytes(), np.uint8).reshape(h, w * bpp)
    rows = rows.astype(np.int32)
    out = []
    for y in range(h):
        line = rows[y]
        up = rows[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = filters[y % len(filters)]
        if f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8)
                   .tobytes())

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    colortype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth,
                                           colortype, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(out), 6)))
        fh.write(chunk(b"IEND", b""))


# --- codecs -----------------------------------------------------------

# (seed, shape, dtype): RGB and grayscale, 8 and 16 bits, odd widths
IMAGES = [(0, (33, 47, 3), np.uint8), (1, (21, 29, 3), np.uint16),
          (2, (17, 31), np.uint8), (3, (40, 64, 1), np.uint16)]


def _image(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    return rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("seed,shape,dtype", IMAGES)
def test_write_png_byte_equal_and_read_back(tmp_path, seed, shape, dtype):
    img = _image(seed, shape, dtype)
    flow_io.write_png(str(tmp_path / "p.png"), img)
    jflow_io.write_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "p.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    got = flow_io.read_png(str(tmp_path / "p.png"))
    ref = jflow_io.read_png(str(tmp_path / "p.png"))
    assert got.dtype == ref.dtype == dtype
    assert np.array_equal(got, ref)
    assert np.array_equal(got.reshape(shape), img)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_mask", [False, True])
def test_flow_png_byte_equal_and_read_back(tmp_path, seed, with_mask):
    rng = np.random.RandomState(seed)
    flow = ((rng.rand(30, 41, 2) - 0.5) * 600).astype(np.float32)
    mask = (rng.rand(30, 41) > 0.4).astype(np.uint16) if with_mask else None
    flow_io.write_flow_png(str(tmp_path / "p.png"), flow, mask)
    jflow_io.write_flow_png(str(tmp_path / "j.png"), flow, mask)
    assert (tmp_path / "p.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    got, got_mask = flow_io.read_flow_png(str(tmp_path / "p.png"))
    ref, ref_mask = jflow_io.read_flow_png(str(tmp_path / "p.png"))
    assert got.dtype == np.float32 and got_mask.dtype == np.uint8
    assert np.array_equal(got, ref) and np.array_equal(got_mask, ref_mask)
    assert np.abs(got - flow).max() <= 1 / 64
    assert pdata.read_flow_png is flow_io.read_flow_png


@pytest.mark.parametrize("seed", [0, 1])
def test_flo_byte_equal_and_read_back(tmp_path, seed):
    flow = np.random.RandomState(seed).randn(23, 37, 2).astype(np.float32)
    flow_io.write_flo(str(tmp_path / "p.flo"), flow)
    jflow_io.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "p.flo").read_bytes() == \
        (tmp_path / "j.flo").read_bytes()
    assert np.array_equal(flow_io.read_flo(str(tmp_path / "p.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        flow_io.read_flo(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("seed,shape,dtype", IMAGES)
def test_filtered_png_python_decoders(tmp_path, seed, shape, dtype):
    """Rows filtered by Sub, Up, Average and Paeth decode to the image in
    both packages' Python codecs."""
    img = _image(seed, shape, dtype)
    img3 = img.reshape(shape[:2] + (-1,))
    path = str(tmp_path / "f.png")
    encode_filtered_png(path, img3)
    got = flow_io.read_png(path)
    assert np.array_equal(got, img3)
    assert np.array_equal(got, jflow_io.read_png(path))


def test_read_png_rejects_bad_input(tmp_path):
    (tmp_path / "x.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        flow_io.read_png(str(tmp_path / "x.png"))
    flow_io.write_png(str(tmp_path / "rgb8.png"),
                      np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError):
        flow_io.read_flow_png(str(tmp_path / "rgb8.png"))


# --- the native library ---------------------------------------------------

def _native_listing():
    return sorted((p.name, p.stat().st_mtime_ns)
                  for p in (ROOT / "native").iterdir())


@pytest.fixture(scope="module")
def native_lib():
    """Builds (or finds) the port's native library; records ``native/``
    before and after."""
    before = _native_listing()
    lib = native.get_lib()
    assert lib is not None, native.build_error()
    return before, _native_listing()


def test_native_builds_in_the_port_build_dir(native_lib):
    before, after = native_lib
    assert native.available() and native.build_error() is None
    path = native.library_path()
    assert path.is_file()
    assert path.parent.parent == ROOT / "upflow_pytorch_tpu_torch" / \
        "_build" / "native"
    assert before == after, "the port's build wrote into native/"


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("seed,shape,dtype", IMAGES)
def test_native_decode_equals_python_and_jax(native_lib, tmp_path, filtered,
                                              seed, shape, dtype):
    img = _image(seed, shape, dtype).reshape(shape[:2] + (-1,))
    path = str(tmp_path / "n.png")
    if filtered:
        encode_filtered_png(path, img)
    else:
        flow_io.write_png(path, img)
    got = native.decode_png(path)
    assert got.dtype == img.dtype and np.array_equal(got, img)
    assert np.array_equal(got, flow_io.read_png(path))
    assert np.array_equal(got, jnative.decode_png(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_native_flow_png_equals_python(native_lib, tmp_path, seed):
    rng = np.random.RandomState(seed)
    flow = ((rng.rand(30, 41, 2) - 0.5) * 600).astype(np.float32)
    mask = (rng.rand(30, 41) > 0.5).astype(np.uint16)
    path = str(tmp_path / "f.png")
    flow_io.write_flow_png(path, flow, mask)
    got, got_mask = native.decode_flow_png(path)
    ref, ref_mask = flow_io.read_flow_png(path)
    assert np.array_equal(got, ref) and np.array_equal(got_mask, ref_mask)
    jgot, jmask = jnative.decode_flow_png(path)
    assert np.array_equal(got, jgot) and np.array_equal(got_mask, jmask)
    assert np.array_equal(kitti.read_flow_png(path)[0], ref)


@pytest.mark.parametrize("flip", [False, True])
def test_native_preprocess_equals_normalize(native_lib, flip):
    img = np.random.RandomState(21).randint(0, 256, (25, 37, 3), np.uint8)
    got = native.preprocess_image(img, flip)
    assert np.array_equal(got, image_io.normalize_image(img, True, flip))
    assert np.array_equal(got, jimage_io.normalize_image(img, True, flip))


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    """Without a compiler the library is unavailable, ``build_error()``
    says why, and the decoders fall back to the Python codec."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    assert "no-such-compiler" in native.build_error()
    img = _image(0, (9, 11, 3), np.uint8)
    path = str(tmp_path / "a.png")
    encode_filtered_png(path, img)
    assert np.array_equal(native.decode_png(path), img)
    assert np.array_equal(image_io.read_image(path), img)
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").rglob("*.so"))


def test_native_concurrent_builds(tmp_path):
    """Three processes building into one empty directory at once each load
    a whole library (written under a temporary name, then renamed)."""
    code = ("import sys; from pathlib import Path; "
            "from upflow_pytorch_tpu_torch.data import native; "
            "native.BUILD_ROOT = Path(sys.argv[1]); "
            "assert native.available(), native.build_error(); "
            "print(native.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == \
        [native.LIB_NAME]


# --- datasets ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL_TREES.items():
            mp.setattr(trees, name, value)
        splits = trees.write_trees(str(root), seed=3, workers=4)
    return str(root), splits


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("split", ["2015_train", "2015_test", "2012_train"])
def test_kitti_eval_items_equal_jax(tree, split):
    root, splits = tree
    got = kitti.KittiFlowEvalDataset(root, split)
    ref = jkitti.KittiFlowEvalDataset(root, split)
    assert kitti.scan_eval_files(root, split) == \
        jkitti.scan_eval_files(root, split)
    assert len(got) == len(ref) == len(splits[split]) > 0
    assert got.has_gt == ref.has_gt == split.endswith("_train")
    for g, r, hw in zip(got, ref, splits[split]):
        assert g.im1.shape == (1,) + tuple(hw) + (3,)
        assert g.name == r.name
        for field in ("im1", "im2", "flow_occ", "mask_occ", "flow_noc",
                      "mask_noc"):
            assert _same(getattr(g, field), getattr(r, field)), field


def test_kitti_eval_ground_truth(tree):
    """flow_occ is valid everywhere, flow_noc where p + F(p) is inside the
    frame, and the images decode to the texture's uint8."""
    root, _ = tree
    s = kitti.KittiFlowEvalDataset(root, "2015_train")[1]
    assert s.mask_occ.min() == 1.0
    assert 0.5 < s.mask_noc.mean() < 1.0
    assert np.array_equal(s.flow_occ, s.flow_noc)
    h, w = s.flow_occ.shape[1:3]
    ys, xs = np.mgrid[0:h, 0:w]
    x = xs + s.flow_occ[0, ..., 0]
    y = ys + s.flow_occ[0, ..., 1]
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    # the file holds the flow to 1/64 px: within that of the frame's edge
    # the exact flow may fall on the other side
    edge = np.minimum(np.minimum(np.abs(x), np.abs(x - (w - 1))),
                      np.minimum(np.abs(y), np.abs(y - (h - 1)))) <= 1 / 64
    differ = (s.mask_noc[0, ..., 0] == 1) != inside
    assert not (differ & ~edge).any()
    with pytest.raises(ValueError):
        kitti.KittiFlowEvalDataset(root, "2016_train")


def test_multiview_scan_equals_jax(tree):
    root, _ = tree
    got = kitti.scan_multiview_pairs(root, "2015", cache=False)
    assert got == jkitti.scan_multiview_pairs(root, "2015", cache=False)
    # per sequence frames 0..15: pairs (0,1)..(7,8) and (13,14), (14,15)
    assert len(got) == 2 * 10
    for p1, p2 in got:
        f1, f2 = int(p1[-6:-4]), int(p2[-6:-4])
        assert f2 == f1 + 1 and not (9 <= f1 <= 12 or 9 <= f2 <= 12)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("epoch", [0, 3])
def test_multiview_items_equal_jax(tree, seed, epoch):
    root, _ = tree
    kw = dict(crop_size=MV_CROP, rho=MV_RHO, seed=seed)
    got = kitti.KittiMultiviewDataset(root, "2015", **kw)
    ref = jkitti.KittiMultiviewDataset(root, "2015", **kw)
    assert got.pairs == ref.pairs and len(got) == len(ref) == 20
    assert os.path.isfile(os.path.join(
        root, "data_scene_flow_multiview", "upflow_tpu_mv_pairs_2015.pkl"))
    for i in range(len(got)):
        g, r = got.item(i, epoch), ref.item(i, epoch)
        assert sorted(g) == sorted(r)
        for key in r:
            assert _same(g[key], r[key]), (i, key)
        x, y = (int(v) for v in g["start"])
        assert np.array_equal(
            g["im1"], g["im1_raw"][y:y + MV_CROP[0], x:x + MV_CROP[1]])


@pytest.mark.parametrize("render", ["clean", "final"])
def test_sintel_eval_items_equal_jax(tree, render):
    root, _ = tree
    got = sintel.SintelEvalDataset(root, render)
    ref = jsintel.SintelEvalDataset(root, render)
    assert sintel.scan_sintel(root, "training", render) == \
        jsintel.scan_sintel(root, "training", render)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.name == r.name
        for field in ("im1", "im2", "flow_occ", "mask_occ", "flow_noc",
                      "mask_noc"):
            assert _same(getattr(g, field), getattr(r, field)), field
    noc = got[0].mask_noc
    assert 0.0 < noc.mean() <= 1.0 and got[0].mask_occ.min() == 1.0


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("epoch", [0, 2])
def test_sintel_train_items_equal_jax(tree, seed, epoch):
    root, _ = tree
    got = sintel.SintelTrainDataset(root, "final", crop_size=SINTEL_CROP,
                                    seed=seed)
    ref = jsintel.SintelTrainDataset(root, "final", crop_size=SINTEL_CROP,
                                     seed=seed)
    assert len(got) == len(ref) == 4
    for i in range(len(got)):
        g, r = got.item(i, epoch), ref.item(i, epoch)
        for key in r:
            assert _same(g[key], r[key]), (i, key)
        assert g["im1"].shape == SINTEL_CROP + (3,)


def test_read_image_equals_jax(tree):
    """Every PNG of the trees through both packages' ``read_image`` (the
    native decoder) and the Python codec: the same pixels."""
    root, _ = tree
    pngs = sorted(Path(root).rglob("*.png"))
    assert len(pngs) > 50
    for p in pngs[::5]:
        got = image_io.read_image(str(p))
        assert got.dtype == np.uint8 and got.shape[2] == 3
        assert np.array_equal(got, jimage_io.read_image(str(p)))
        raw = flow_io.read_png(str(p))
        if raw.dtype == np.uint8:
            assert np.array_equal(got, np.broadcast_to(
                raw, raw.shape[:2] + (3,)))


def _mixed_sizes_dataset(root, mod):
    """Pairs of two KITTI 2015 frame sizes, as a shuffled multiview batch
    of sequences of different sizes would give."""
    items = mod.scan_eval_files(root, "2015_train")
    pairs = [(items[0]["im1"], items[0]["im2"]),
             (items[-1]["im1"], items[-1]["im2"])]
    return mod.KittiMultiviewDataset(root, crop_size=MV_CROP, rho=MV_RHO,
                                     pairs=pairs)


def test_loaders_raise_on_mixed_raw_sizes(tree):
    """Both loaders stack ``im1_raw`` at each frame's native size, so a
    batch of two sizes raises (a limit shared with the JAX package)."""
    root, splits = tree
    assert splits["2015_train"][0] != splits["2015_train"][-1]
    port = pipeline.DataLoader(_mixed_sizes_dataset(root, kitti),
                               batch_size=2, shuffle=False, num_workers=1,
                               device="cpu")
    with pytest.raises(ValueError):
        next(iter(port))
    port.close()
    ref = jpipe.DataLoader(_mixed_sizes_dataset(root, jkitti), batch_size=2,
                           shuffle=False, num_workers=1)
    with pytest.raises(ValueError):
        ref._produce()  # the JAX producer, run in this thread
    ref.close()
    one = pipeline.DataLoader(kitti.KittiMultiviewDataset(
        root, crop_size=MV_CROP, rho=MV_RHO), batch_size=4, num_workers=2,
        device="cpu")
    batch = next(iter(one))
    one.close()
    assert batch["im1_raw"].shape == (4,) + SMALL_TREES["MV_SIZE"] + (3,)
    assert isinstance(batch["im1"], torch.Tensor)
