"""RAFT on the port's serving entry (``models/raft.py``, the lookup of
``ops/kernels/corr_lookup.py``) against the plain fp32 reference
``tests/raft_reference.py`` (princeton-vl/RAFT's ``core/*.py``).

On the CPU at 124 x 150 (padded to 128 x 152: a 16 x 19 grid, levels
16 x 19 .. 2 x 2) with 3 iterations and seeded weights.  A smaller frame
would leave the coarsest level one pixel high or wide, where corr.py's
``bilinear_sampler`` divides by ``W - 1 = 0``: RAFT itself gives NaN
there.  The tests marked ``card`` need a CUDA device and skip without
one; on the card, without the JAX configuration of ``tests/conftest.py``:

    python -m pytest tests/test_torch_port_raft.py -m card \\
        --noconftest -p no:cacheprovider -q
"""

import math

import numpy as np
import pytest
import torch

import raft_reference as ref
from upflow_pytorch_tpu_torch.config import RAFTConfig
from upflow_pytorch_tpu_torch.models import entry, raft
from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg
from upflow_pytorch_tpu_torch.ops.kernels import corr_lookup as cl

HW = (124, 150)
ITERS = 3
SEED = 5
KEYS = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")


def _images(b, h, w, seed):
    """NHWC frames in [0, 255]: a smooth texture and its shift by (2, 3)
    px, plus fine noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h + 8, 0:w + 8].astype(np.float32)
    canvas = np.zeros((b, h + 8, w + 8, 3), np.float32)
    for _ in range(5):
        fy, fx = rng.uniform(0.02, 0.3, size=2)
        phase = rng.uniform(0, 2 * np.pi, size=(b, 1, 1, 3))
        canvas += np.sin(fy * yy[None, :, :, None] + fx * xx[None, :, :, None]
                         + phase)
    canvas += 0.2 * rng.randn(*canvas.shape).astype(np.float32)
    canvas = 255 * (canvas - canvas.min()) / (canvas.max() - canvas.min())
    return (np.ascontiguousarray(canvas[:, 4:4 + h, 4:4 + w]),
            np.ascontiguousarray(canvas[:, 2:2 + h, 1:1 + w]))


def _build(dtype="float32", iters=ITERS):
    return entry.build_model(RAFTConfig(iters=iters, compute_dtype=dtype),
                             "cpu", seed=SEED)


@pytest.fixture(scope="module")
def pair():
    return _images(1, *HW, 0)


@pytest.fixture(scope="module")
def fp32_model():
    return _build()


@pytest.fixture(scope="module")
def reference(fp32_model, pair):
    """The reference's ((flow8, flow) forward, (flow8, flow) backward),
    NCHW, on the fp32 model's weights."""
    p = {k: v.float() for k, v in fp32_model.state_dict().items()}
    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in pair)
    with torch.no_grad():
        return ref.raft(p, a, b, ITERS), ref.raft(p, b, a, ITERS)


@pytest.fixture(scope="module")
def served(fp32_model, pair):
    return entry.forward(fp32_model, *pair)


def _epe(nhwc, nchw):
    return float((nhwc.permute(0, 3, 1, 2) - nchw).norm(dim=1).mean())


# --- the model against the reference ----------------------------------------

def test_fp32_forward_matches_the_reference(served, reference):
    """Both directions, the final flows and the 1/8 flows, within 1e-4 px
    mean end-point error: the same fp32 arithmetic, summed in another
    order where the port merges convs and batches the directions."""
    (f8, fu), (b8, bu) = reference
    assert _epe(served["flow_f_out"], fu) <= 1e-4
    assert _epe(served["flow_b_out"], bu) <= 1e-4
    (up_f, up_b), (low_f, low_b) = served["flows"]
    assert torch.equal(up_f, served["flow_f_out"])
    assert _epe(low_f, f8) <= 1e-4 and _epe(low_b, b8) <= 1e-4
    assert float(fu.norm(dim=1).mean()) > 0.5  # the flow is not trivial


def test_bf16_forward_matches_the_reference(fp32_model, pair, reference):
    """bf16 keeps 8 significant bits: each conv output is rounded by up to
    2^-9 of itself, and some 20 rounded layers lie on each update's path,
    so the flow may part from fp32's by about sqrt(20) * 2^-9 ~ 1% of its
    size, growing with the iterations.  The bar is 2^-6 of the mean flow
    (1.6%); the port reads about 0.7% here."""
    model = _build("bfloat16")
    model.load_state_dict(fp32_model.state_dict())
    out = entry.forward(model, *pair)
    (_, fu), (_, bu) = reference
    for key, want in (("flow_f_out", fu), ("flow_b_out", bu)):
        size = float(want.norm(dim=1).mean())
        epe = _epe(out[key], want)
        assert 0 < epe <= 2.0 ** -6 * size, (key, epe, size)


def test_weights_are_raft_s(fp32_model):
    """RAFT's module names and widths: 5,257,536 parameters (the paper's
    5.3 M), batch norm in ``cnet`` only, its statistics drawn."""
    sd = fp32_model.state_dict()
    assert sum(p.numel() for p in fp32_model.parameters()) == 5257536
    assert sd["update_block.mask.2.weight"].shape == (576, 256, 1, 1)
    assert sd["update_block.encoder.convc1.weight"].shape == (256, 324, 1, 1)
    assert sd["update_block.gru.convz1.weight"].shape == (128, 384, 1, 5)
    assert sd["update_block.gru.convq2.weight"].shape == (128, 384, 5, 1)
    assert sd["fnet.conv2.weight"].shape == (256, 128, 1, 1)
    assert "cnet.layer2.0.norm3.running_var" in sd
    assert not any(k.startswith("fnet.") and "norm" in k for k in sd)
    assert not torch.equal(sd["cnet.norm1.running_var"],
                           torch.ones(64))  # drawn from the seed


def test_a_saved_state_dict_loads(fp32_model, tmp_path):
    """A state dict saved by DataParallel (``module.`` keys), as published
    checkpoints are."""
    path = tmp_path / "raft.pth"
    torch.save({"module." + k: v for k, v in
                fp32_model.state_dict().items()}, path)
    model = entry.build_model(RAFTConfig(iters=ITERS), "cpu", seed=SEED + 1,
                              weights=str(path))
    for k, v in fp32_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_the_seed_draws_the_weights():
    a, b, c = _build(), _build(), entry.build_model(
        RAFTConfig(iters=ITERS), "cpu", seed=SEED + 1)
    w = "update_block.flow_head.conv2.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])


# --- the pieces --------------------------------------------------------------

def _lookup_case(n=2, h=16, w=19, seed=0):
    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(n, 32, h, w, generator=g)
    f2 = torch.randn(n, 32, h, w, generator=g)
    coords = raft.coords_grid(n, h, w, "cpu") + 6 * torch.randn(
        n, 2, h, w, generator=g)
    coords[:, 0, 0, :3] = torch.tensor([-6.5, w + 3.2, 1e7])
    return f1, f2, coords


def test_lookup_plain_is_corr_py_s():
    """The plain lookup against corr.py's ``CorrBlock`` over the port's
    pyramid, which is ``CorrBlock``'s volume: bit for bit."""
    f1, f2, coords = _lookup_case()
    pyramid = raft.corr_pyramid(f1, f2)
    want = ref.corr_pyramid(f1, f2)
    for got, exp in zip(pyramid, want):
        assert torch.allclose(got, exp, rtol=1e-6, atol=1e-6)
    assert torch.equal(cl.corr_lookup_plain(want, coords),
                       ref.corr_lookup(want, coords))
    assert cl.corr_lookup(want, coords, torch.bfloat16).dtype == \
        torch.bfloat16


def test_lookup_tap_order():
    """On a ramp plane, value = x + 100 y of the second frame's pixel,
    bilinear sampling is exact: channel l * 81 + i * 9 + j holds the
    sample at (x / 2^l + i - 4, y / 2^l + j - 4), the x offset on the slow
    axis as corr.py's ``meshgrid(dy, dx)`` gives it.  Every pixel of a
    2 x 3 grid looks near the middle of a 128 x 128 plane, so every tap of
    every level lies inside it."""
    n, h, w, side = 1, 2, 3, 128
    ys, xs = torch.meshgrid(torch.arange(side).float(),
                            torch.arange(side).float(), indexing="ij")
    levels = [(xs + 100 * ys)[None, None].repeat(n * h * w, 1, 1, 1)]
    for _ in range(3):
        levels.append(torch.nn.functional.avg_pool2d(levels[-1], 2, 2))
    coords = raft.coords_grid(n, h, w, "cpu") * 0.5 + torch.tensor(
        [64.25, 60.5])[None, :, None, None]
    out = cl.corr_lookup_plain(levels, coords)
    for y in range(h):
        for x in range(w):
            cx, cy = float(coords[0, 0, y, x]), float(coords[0, 1, y, x])
            for lv in range(4):
                s = 2.0 ** lv
                # a pooled ramp: s (u + 100 v) + (s - 1) / 2 * 101
                for i in range(9):
                    for j in range(9):
                        want = (s * (cx / s + i - 4 + 100 * (cy / s + j - 4))
                                + (s - 1) / 2 * 101)
                        got = float(out[0, lv * 81 + i * 9 + j, y, x])
                        assert math.isclose(got, want, rel_tol=1e-5), (
                            lv, i, j)


def test_lookup_has_no_gradient_rule():
    f1, f2, coords = _lookup_case()
    coords.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        cl.corr_lookup(raft.corr_pyramid(f1, f2), coords)


def test_convex_upsample():
    """The reference's ``upsample_flow``, and where the mask picks the
    centre tap, each 8 x 8 block is 8 times its pixel's flow."""
    g = torch.Generator().manual_seed(3)
    flow = torch.randn(2, 2, 5, 7, generator=g)
    mask = torch.randn(2, 576, 5, 7, generator=g)
    assert torch.allclose(raft.convex_upsample(flow, mask),
                          ref.upsample_flow(flow, mask), atol=1e-6)
    centre = torch.full((2, 1, 9, 8, 8, 5, 7), -1e4)
    centre[:, :, 4] = 0.0
    up = raft.convex_upsample(flow, centre.view(2, 576, 5, 7))
    want = 8 * flow.repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)
    assert torch.allclose(up, want, atol=1e-5)


def test_pad_and_crop_kitti_frame():
    """375 x 1242 -> 376 x 1248: left 3, right 3, top 0, bottom 1, by
    replication; the crop gives the frame back."""
    pad = raft.padding(375, 1242)
    assert pad == [3, 3, 0, 1] == ref.pad_amounts(375, 1242)
    assert raft.padding(376, 1248) == [0, 0, 0, 0]
    x = torch.randn(1, 2, 375, 1242)
    padded = torch.nn.functional.pad(x, pad, mode="replicate")
    assert padded.shape[-2:] == (376, 1248)
    assert torch.equal(padded[..., -1, 3:-3], x[..., -1, :])
    assert torch.equal(padded[..., :-1, 0], x[..., :, 0])
    assert torch.equal(raft.unpad(padded, pad), x)


def test_conv3x3_seg_relu_plain():
    """``RELU`` is the ReLU of the conv without an activation, rounded
    once either way; the kernel's codes: 0 none, 1 LeakyReLU, 2 ReLU."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 64, 9, 11, generator=g).bfloat16()
    w = torch.randn(8, 64, 3, 3, generator=g) / 24
    b = torch.randn(8, generator=g)
    none = seg.conv3x3_seg_plain(x, w, b, 1, False)
    relu = seg.conv3x3_seg_plain(x, w, b, 1, seg.RELU)
    assert torch.equal(relu, torch.where(none >= 0, none, 0.0))
    assert (none < 0).any()
    assert [seg.epilogue(r) for r in (False, True, seg.RELU)] == [0, 1, 2]


# --- the entry ---------------------------------------------------------------

def test_entry_outputs(served, pair):
    b, (h, w) = 1, HW
    shapes = {"flow_f_out": (b, h, w, 2), "flow_b_out": (b, h, w, 2),
              "occ_fw": (b, h, w, 1), "occ_bw": (b, h, w, 1)}
    for key, shape in shapes.items():
        assert tuple(served[key].shape) == shape
        assert served[key].dtype == torch.float32
    assert set(torch.unique(served["occ_fw"]).tolist()) <= {0.0, 1.0}
    (up_f, up_b), (low_f, low_b) = served["flows"]
    assert tuple(up_b.shape) == (b, h, w, 2)
    assert tuple(low_f.shape) == tuple(low_b.shape) == (b, 16, 19, 2)
    tensors = [served[k] for k in KEYS] + [up_f, up_b, low_f, low_b]
    assert len({t.data_ptr() for t in tensors}) == len(tensors)


def test_iterations_counter(fp32_model, pair):
    before = raft.RAFTNet.iterations
    entry.forward(fp32_model, *pair)
    assert raft.RAFTNet.iterations - before == ITERS


def test_graph_key_separates_iters(fp32_model):
    other = _build(iters=ITERS + 1)
    cpu = torch.device("cpu")
    shape = (1,) + HW + (3,)
    key = entry.graph_key(fp32_model, shape, shape, cpu)
    assert key[0] != entry.graph_key(other, shape, shape, cpu)[0]
    assert key == entry.graph_key(fp32_model, shape, shape, cpu)


class _Shard:
    def at(self, width):
        return None


def test_forward_with_a_shard_raises(fp32_model, pair):
    with pytest.raises(ValueError, match="width shard"):
        entry.forward(fp32_model, *pair, shard=_Shard())


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see the module "
                    "docstring)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n,h,w", [(2, 47, 156), (3, 17, 45), (1, 16, 16)],
                         ids=["cell_47x156", "odd_17x45", "b1_16x16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_lookup_kernel_matches_plain(cuda, n, h, w, dtype):
    """The kernel skips ``grid_sample``'s normalising round trip, which
    moves a coordinate by a few fp32 ulps (< 1e-4 px at 156 px): values
    agree within 1e-4 of the volume's largest, and at bf16 also within one
    bf16 ulp (at most 2^-7 of the value), where the two round the
    near-equal fp32 values apart."""
    f1, f2, coords = _lookup_case(n, h, w, seed=h)
    pyramid = raft.corr_pyramid(f1.to(cuda).bfloat16(),
                                f2.to(cuda).bfloat16())
    coords = coords.to(cuda)
    got = cl.corr_lookup_cuda(pyramid, coords, dtype).float()
    want = cl.corr_lookup_plain(pyramid, coords, dtype).float()
    bar = 1e-4 * pyramid[0].abs().max()
    if dtype == torch.bfloat16:
        bar = bar + 2.0 ** -7 * want.abs()
    assert bool(((got - want).abs() <= bar).all())
    assert torch.equal(got, cl.corr_lookup_cuda(pyramid, coords,
                                                dtype).float())


@pytest.mark.card
def test_raft_replay_is_the_eager_forward(cuda):
    model = entry.build_model(RAFTConfig(compute_dtype="bfloat16"), "cuda",
                              seed=SEED)
    pair = _images(1, 375, 1242, 1)
    with entry.eager_entry():
        want = entry.forward(model, *pair)
    f = entry.forward
    c0, r0 = f.graph_captures, f.graph_replays
    got = [entry.forward(model, *pair) for _ in range(4)]
    torch.cuda.synchronize()
    assert (f.graph_captures - c0, f.graph_replays - r0) == (1, 2)
    for out in got:
        assert all(torch.equal(out[k], want[k]) for k in KEYS)
