"""GMFlow on the port's serving entry (``models/gmflow.py``, the window
attention of ``ops/attention.py``, the matching of
``ops/kernels/global_match.py``) against the plain fp32 reference
``tests/gmflow_reference.py`` (haofeixu/gmflow's ``gmflow/*.py``).

On the CPU at the published widths with seeded weights (the layer norms'
weights and biases drawn too, so that they do work), on 2 pairs of 64 x 96
frames: a 8 x 12 grid at 1/8, cut into 2 x 2 windows of 4 x 6, whose
shifted blocks roll by (2, 3) and so take Swin's mask.  The tests marked
``card`` need a CUDA device and skip without one; on the card, without the
JAX configuration of ``tests/conftest.py``:

    python -m pytest tests/test_torch_port_gmflow.py -m card \\
        --noconftest -p no:cacheprovider -q
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import gmflow_reference as ref
from raft_reference import fp32
from upflow_pytorch_tpu_torch.config import (
    GMFlowConfig, OcclusionCheck, RAFTConfig, UPFlowConfig)
from upflow_pytorch_tpu_torch.models import entry, gmflow, raft
from upflow_pytorch_tpu_torch.models.occlusion import occ_check
from upflow_pytorch_tpu_torch.ops import attention
from upflow_pytorch_tpu_torch.ops import conv as conv_ops
from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg
from upflow_pytorch_tpu_torch.ops.kernels import global_match as gm

HW = (64, 96)
B = 2
SEED = 7
KEYS = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")
WIDTHS = {"feature_channels": 128, "num_transformer_layers": 6,
          "upsample_factor": 8}
# the same fp32 arithmetic as the reference, summed in another order where
# the port merges the projections and batches the directions: flows agree
# to ~2e-5 px, features to ~1e-6 of their size
FLOW_TOL = 1e-4  # px, mean end-point error
REL_TOL = 1e-5  # of a stage's largest value


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


def _build(dtype="float32", seed=SEED):
    return entry.build_model(GMFlowConfig(compute_dtype=dtype), "cpu",
                             seed=seed)


@pytest.fixture(scope="module")
def fp32_model():
    model = _build()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".norm" in name:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.2 * torch.randn(p.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def params(fp32_model):
    return {k: v.float() for k, v in fp32_model.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    return _images(B, *HW, 0)


@pytest.fixture(scope="module")
def nchw(pair):
    return tuple(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
                 for x in pair)


@pytest.fixture(scope="module")
def reference(params, nchw):
    """The reference's (1/8 flows, flows), forward then backward, NCHW."""
    with torch.no_grad(), fp32():
        return ref.gmflow(params, *nchw, WIDTHS)


@pytest.fixture(scope="module")
def served(fp32_model, pair):
    return entry.forward(fp32_model, *pair)


def _epe(a, b):
    return float((a - b).norm(dim=1).mean())


def _close(got, want, tol=REL_TOL):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def _backbone_input(nchw):
    """Both frames padded and normalised as the reference does, (2B, 3,
    H', W')."""
    pad = ref.pad_amounts(*HW)
    x = F.pad(torch.cat(nchw), pad, mode="replicate")
    mean = torch.tensor(ref.MEAN).view(1, 3, 1, 1)
    std = torch.tensor(ref.STD).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def _tokens(x):
    return x.flatten(2).transpose(1, 2).contiguous()


# --- each stage against the reference ----------------------------------------

def test_backbone(fp32_model, params, nchw):
    x = _backbone_input(nchw)
    with torch.no_grad(), fp32():
        want = ref.backbone(params, x)
        got = fp32_model.backbone(x)
    assert got.shape == (2 * B, 128, 8, 12)
    assert _close(got, want)


def test_position_code():
    """The code added in each window is ``feature_add_position``'s."""
    g = torch.Generator().manual_seed(2)
    f0, f1 = torch.randn(2, B, 128, 8, 12, generator=g)
    want0, want1 = ref.feature_add_position(f0, f1, 2, 128)
    code = gmflow.position_code(128, 8, 12, 2, torch.device("cpu"))
    assert torch.allclose(f0 + code, want0, atol=1e-6)
    assert torch.allclose(f1 + code, want1, atol=1e-6)
    assert torch.equal(code[:, :4, :6], code[:, 4:, 6:])


@pytest.mark.parametrize("block", [0, 1], ids=["windows", "shifted"])
def test_transformer_block(fp32_model, params, block):
    """Block 0 (windows) and block 1 (shifted windows under the mask):
    self-attention, then cross-attention with the feed-forward layer."""
    g = torch.Generator().manual_seed(3 + block)
    h, w = 8, 12
    src = torch.randn(2 * B, h * w, 128, generator=g)
    tgt = torch.randn(2 * B, h * w, 128, generator=g)
    name = "transformer.layers.%d" % block
    mask = ref.generate_shift_window_attn_mask((h, w), 4, 6, 2, 3, "cpu")
    with torch.no_grad(), fp32():
        mid = ref.transformer_layer(params, name + ".self_attn", src, src,
                                    h, w, mask, block == 1, True)
        want = ref.transformer_layer(params, name + ".cross_attn_ffn", mid,
                                     tgt, h, w, mask, block == 1, False)
        got = fp32_model.transformer.layers[block](src, tgt, h, w, 2,
                                                   torch.float32)
    assert _close(got, want)


def test_matching_and_propagation(fp32_model, params):
    """Both directions of the matching in one ``global_match`` call (the
    second frame's features against the first's is the softmax of the
    transposed correlation), then the propagation over both."""
    g = torch.Generator().manual_seed(5)
    h, w = 8, 12
    f0, f1 = 3 * torch.randn(2, B, 128, h, w, generator=g)
    with torch.no_grad(), fp32():
        want = ref.global_correlation_softmax(f0, f1)
        feats = torch.cat([f0, f1])
        want_prop = ref.feature_flow_attention(params, feats, want)
        t = _tokens(feats)
        grid = gmflow.token_grid(2 * B, h, w, torch.device("cpu"))
        flow = gm.global_match(t, gmflow.swap(t), grid,
                               1 / math.sqrt(128)) - grid
        ffa = fp32_model.feature_flow_attn
        query = gmflow.linear(ffa.q, t)
        prop = gm.global_match(query, gmflow.linear(ffa.k, query), flow,
                               1 / math.sqrt(128))
    got = flow.transpose(1, 2).reshape(2 * B, 2, h, w)
    got_prop = prop.transpose(1, 2).reshape(2 * B, 2, h, w)
    assert _epe(got, want) <= 1e-5 and _epe(got_prop, want_prop) <= 1e-5
    assert float(want.abs().mean()) > 0.5


def test_upsampling(fp32_model, params):
    g = torch.Generator().manual_seed(6)
    flow = 3 * torch.randn(2, 2, 8, 12, generator=g)
    feat = torch.randn(2, 128, 8, 12, generator=g)
    up = fp32_model.upsampler
    with torch.no_grad(), fp32():
        want = ref.upsample_flow(params, flow, feat, 8)
        mask = raft.conv(up[2], raft.conv(up[0], torch.cat([flow, feat], 1),
                                          relu=True))
        got = raft.convex_upsample(flow, mask)
    assert got.shape == (2, 2, 64, 96) and _close(got, want)


# --- the whole model ---------------------------------------------------------

def test_fp32_forward_matches_the_reference(served, reference):
    """Both directions, the final flows and the 1/8 flows."""
    flow8, flow = reference
    assert _epe(served["flow_f_out"].permute(0, 3, 1, 2), flow[:B]) <= \
        FLOW_TOL
    assert _epe(served["flow_b_out"].permute(0, 3, 1, 2), flow[B:]) <= \
        FLOW_TOL
    (up_f, up_b), (low_f, low_b) = served["flows"]
    assert torch.equal(up_f, served["flow_f_out"])
    assert torch.equal(up_b, served["flow_b_out"])
    low = torch.cat([low_f, low_b]).permute(0, 3, 1, 2)
    assert _epe(low, flow8) <= FLOW_TOL / 8
    assert float(flow.norm(dim=1).mean()) > 0.5  # the flow is not trivial


def test_entry_outputs_and_occlusion(served, reference):
    """NHWC fp32 outputs, each a tensor of its own, and the occlusion masks
    of UPFlow's check on the reference's flows."""
    h, w = HW
    shapes = {"flow_f_out": (B, h, w, 2), "flow_b_out": (B, h, w, 2),
              "occ_fw": (B, h, w, 1), "occ_bw": (B, h, w, 1)}
    for key, shape in shapes.items():
        assert tuple(served[key].shape) == shape
        assert served[key].dtype == torch.float32
    (up_f, up_b), (low_f, low_b) = served["flows"]
    assert tuple(low_f.shape) == tuple(low_b.shape) == (B, 8, 12, 2)
    tensors = [served[k] for k in KEYS] + [up_f, up_b, low_f, low_b]
    assert len({t.data_ptr() for t in tensors}) == len(tensors)
    _, flow = reference
    occ = OcclusionCheck()
    with torch.no_grad():
        want_f, want_b = occ_check(flow[:B], flow[B:], occ.alpha_1,
                                   occ.alpha_2, occ.occ_check_obj_out_all,
                                   occ.occ_type)
    for key, want in (("occ_fw", want_f), ("occ_bw", want_b)):
        got = served[key].permute(0, 3, 1, 2)
        assert float((got != want).float().mean()) <= 1e-3
    assert 0.0 < float(served["occ_fw"].mean()) < 1.0


def test_bf16_forward_departs_further(fp32_model, pair, reference):
    """bf16 keeps 8 significant bits, and the global softmax over every
    position turns the features' rounding into flow (the scores reach
    ~100, so near-tied matches swap): the bf16 forward parts from the
    reference by far more than the fp32 tolerance, and stays within a
    quarter of the mean flow."""
    model = _build("bfloat16")
    model.load_state_dict(fp32_model.state_dict())
    out = entry.forward(model, *pair)
    _, flow = reference
    for key, want in (("flow_f_out", flow[:B]), ("flow_b_out", flow[B:])):
        epe = _epe(out[key].permute(0, 3, 1, 2), want)
        size = float(want.norm(dim=1).mean())
        assert 100 * FLOW_TOL < epe <= 0.25 * size, (key, epe, size)


# --- the pieces --------------------------------------------------------------

@pytest.mark.parametrize("n,length,keys,block", [
    (2, 96, 96, 1024), (3, 70, 45, 16), (1, 33, 130, 7)],
    ids=["grid", "ragged", "one_item"])
def test_global_match_plain_is_the_naive_softmax(monkeypatch, n, length,
                                                 keys, block):
    """The plain version's blocks of queries give the whole matrix's
    softmax; bf16 operands are widened, not rounded again."""
    monkeypatch.setattr(gm, "PLAIN_BLOCK", block)
    g = torch.Generator().manual_seed(length)
    q = (4 * torch.randn(n, length, 128, generator=g)).bfloat16()
    k = (4 * torch.randn(n, keys, 128, generator=g)).bfloat16()
    v = 50 * torch.randn(n, keys, 2, generator=g)
    scores = torch.matmul(q.double(), k.double().transpose(1, 2)) / 11.3
    want = torch.matmul(torch.softmax(scores, -1), v.double())
    got = gm.global_match(q, k, v, 1 / 11.3)
    assert got.dtype == torch.float32 and got.shape == (n, length, 2)
    assert torch.allclose(got.double(), want, atol=1e-3, rtol=1e-4)


def test_global_match_has_no_gradient_rule():
    q = torch.randn(1, 4, 128, requires_grad=True)
    with pytest.raises(NotImplementedError):
        gm.global_match(q, q.detach(), torch.zeros(1, 4, 2), 1.0)


def test_the_mask_is_swins():
    """-100 between tokens of different regions of the rolled map, 0
    within one: ``generate_shift_window_attn_mask`` at the tests' grid and
    at the cell's 48 x 156 (windows of 24 x 78, shifts of 12 and 39)."""
    for h, w in ((8, 12), (48, 156)):
        sh, sw = attention.shifts(h, w, 2)
        want = ref.generate_shift_window_attn_mask(
            (h, w), h // 2, w // 2, sh, sw, "cpu")
        got = attention.shift_window_mask(h, w, 2, torch.float32,
                                          torch.device("cpu"))
        assert torch.equal(got, want)
    assert set(torch.unique(got).tolist()) == {-100.0, 0.0}
    assert not bool(got[0].any())  # the first window holds one region
    m = attention.shift_window_mask(48, 156, 2, torch.bfloat16,
                                    torch.device("cpu"))
    assert m.dtype == torch.bfloat16 and torch.equal(m.float(), got)


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_window_attention_is_published(shifted):
    """``to_windows``, ``attend`` and ``from_windows`` are
    ``single_head_split_window_attention``, the mask included."""
    g = torch.Generator().manual_seed(8)
    h, w = 8, 12
    q, k, v = torch.randn(3, 2, h * w, 128, generator=g)
    mask = attention.shift_window_mask(h, w, 2, torch.float32,
                                       torch.device("cpu"))
    want = ref.single_head_split_window_attention(q, k, v, 2, shifted, h, w,
                                                  mask)
    win = [attention.to_windows(x, h, w, 2, shifted) for x in (q, k, v)]
    got = attention.from_windows(
        attention.attend(*win, mask if shifted else None), h, w, 2, shifted)
    assert _close(got, want)


def test_parameters_are_gmflows(fp32_model):
    """4,680,288 parameters (the paper's 4.7 M) under GMFlow's state dict
    names, so a published checkpoint loads strictly."""
    sd = fp32_model.state_dict()
    assert sum(p.numel() for p in fp32_model.parameters()) == 4680288
    shapes = {
        "backbone.conv1.weight": (64, 3, 7, 7),
        "backbone.layer1.0.conv1.weight": (64, 64, 3, 3),
        "backbone.layer2.0.downsample.0.weight": (96, 64, 1, 1),
        "backbone.layer3.0.downsample.0.bias": (128,),
        "backbone.conv2.bias": (128,),
        "transformer.layers.5.self_attn.q_proj.weight": (128, 128),
        "transformer.layers.0.cross_attn_ffn.mlp.0.weight": (1024, 256),
        "transformer.layers.3.cross_attn_ffn.mlp.2.weight": (128, 1024),
        "transformer.layers.1.cross_attn_ffn.norm2.bias": (128,),
        "feature_flow_attn.k_proj.bias": (128,),
        "upsampler.0.weight": (256, 130, 3, 3),
        "upsampler.2.weight": (576, 256, 1, 1),
    }
    for key, shape in shapes.items():
        assert tuple(sd[key].shape) == shape, key
    assert "backbone.conv1.bias" not in sd
    assert "backbone.layer1.0.conv1.bias" not in sd
    assert "backbone.layer1.0.downsample.0.weight" not in sd
    assert "transformer.layers.0.self_attn.mlp.0.weight" not in sd
    assert len(sd) == 123


def test_a_published_checkpoint_loads(fp32_model, tmp_path):
    """GMFlow's checkpoints hold the state dict under ``model``, its keys
    possibly with DataParallel's ``module.``."""
    path = tmp_path / "gmflow_kitti.pth"
    torch.save({"model": {"module." + k: v for k, v in
                          fp32_model.state_dict().items()}, "step": 1}, path)
    model = entry.build_model(GMFlowConfig(), "cpu", seed=SEED + 1,
                              weights=str(path))
    for k, v in fp32_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_the_seed_draws_the_weights():
    a, b, c = _build(), _build(), _build(seed=SEED + 1)
    w = "transformer.layers.2.cross_attn_ffn.mlp.0.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])


def test_attention_calls_a_request(fp32_model, pair):
    before = dict(gmflow.GMFlowNet.attention_calls)
    entry.forward(fp32_model, *pair)
    after = gmflow.GMFlowNet.attention_calls
    assert {k: after[k] - before[k] for k in after} == {
        "window": 6, "shifted_window": 6, "global_match": 1,
        "propagate": 1}


class _Shard:
    def at(self, width):
        return None


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_the_card_serves_bf16_alone(device):
    """GMFlow's default is the card's one dtype, bf16; ``build_model``
    refuses 'float32' for a card before it builds anything (its
    ``global_match`` takes bf16), and builds it for the CPU."""
    assert GMFlowConfig().compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="CPU alone"):
        entry.build_model(GMFlowConfig(compute_dtype="float32"), device)
    assert _build().dtype == torch.float32


def test_forward_with_a_shard_raises(fp32_model, pair):
    with pytest.raises(ValueError, match="width shard"):
        entry.forward(fp32_model, *pair, shard=_Shard())


# --- what GMFlow shares with RAFT and UPFlow ---------------------------------

def test_one_occlusion_check_for_every_network():
    """The entry's occlusion settings come from ``OcclusionCheck``:
    UPFlow's knobs default to it, RAFT and GMFlow name it."""
    eval_check = OcclusionCheck()
    assert UPFlowConfig().occlusion == eval_check
    assert RAFTConfig().occlusion == GMFlowConfig().occlusion == eval_check
    assert UPFlowConfig(alpha_1=0.2).occlusion.alpha_1 == 0.2
    assert not any(hasattr(c, "alpha_1") for c in (RAFTConfig(),
                                                   GMFlowConfig()))


def test_padding_factor():
    """375 x 1242 pads to 384 x 1248 at GMFlow's 16 (left 3, right 3,
    bottom 9) and to 376 x 1248 at RAFT's 8."""
    assert raft.padding(375, 1242, 16) == [3, 3, 0, 9] == \
        ref.pad_amounts(375, 1242)
    assert raft.padding(375, 1242) == [3, 3, 0, 1]
    assert raft.padding(384, 1248, 16) == [0, 0, 0, 0]


def test_convs_without_bias():
    """``conv3x3_seg``'s plain version and the plain-conv route take
    ``bias=None``: the conv with a zero bias, bit for bit."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 64, 9, 11, generator=g).bfloat16()
    w = torch.randn(8, 64, 3, 3, generator=g) / 24
    zero = torch.zeros(8)
    assert torch.equal(seg.conv3x3_seg(x, w, None, 1, seg.RELU),
                       seg.conv3x3_seg(x, w, zero, 1, seg.RELU))
    assert torch.equal(conv_ops.conv_plain_route(x, w, None, 2, 1, 1, False),
                       conv_ops.conv_plain_route(x, w, zero, 2, 1, 1, False))
    block = raft.ResidualBlock(64, 64, "instance", bias=False)
    assert block.conv1.bias is None and block.conv2.bias is None
    assert torch.isfinite(block(x)).all()


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see the module "
                    "docstring)")
    return torch.device("cuda", 0)


def _match_inputs(n, length, keys, device):
    """The kernel check's q, k (bf16) and v: peaked softmaxes over values
    spread over [0, 100)."""
    g = torch.Generator(device=device).manual_seed(length)
    q = (4 * torch.randn(n, length, 128, device=device, generator=g)
         ).bfloat16()
    k = (4 * torch.randn(n, keys, 128, device=device, generator=g)
         ).bfloat16()
    v = 100 * torch.rand(n, keys, 2, device=device, generator=g)
    return q, k, v


def _tile_dropped(q, k, v, match):
    """``match`` with the last key tile (64 keys) left out, as a kernel
    that missed it would compute."""
    return match(q, k[:, :-64].contiguous(), v[:, :-64].contiguous(),
                 1 / math.sqrt(128))


def test_a_dropped_key_tile_fails_the_kernels_check():
    """The card's check of ``global_match`` (1e-3 of v's largest value)
    sees a kernel that leaves out the last of the 117 key tiles at the
    cell's shapes: the queries whose softmax peaks there take another
    key's value."""
    q, k, v = _match_inputs(2, 7488, 7488, torch.device("cpu"))
    want = gm.global_match_plain(q, k, v, 1 / math.sqrt(128))
    dropped = _tile_dropped(q, k, v, gm.global_match_plain)
    assert float((dropped - want).abs().max()) > 1e-3 * float(
        v.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("n,length,keys", [(2, 7488, 7488), (3, 100, 77),
                                           (1, 64, 1)],
                         ids=["cell_48x156", "ragged", "one_key"])
def test_global_match_kernel_matches_plain(cuda, n, length, keys):
    """The kernel and the plain version sum the same bf16 products in fp32
    in other orders, and the kernel's exp2 is within 2 ulp: outputs agree
    within 1e-3 of v's largest value; the kernel with its last key tile
    left out does not."""
    q, k, v = _match_inputs(n, length, keys, cuda)
    got = gm.global_match_cuda(q, k, v, 1 / math.sqrt(128))
    want = gm.global_match_plain(q, k, v, 1 / math.sqrt(128))
    bar = 1e-3 * float(v.abs().max())
    assert float((got - want).abs().max()) <= bar
    assert torch.equal(got, gm.global_match_cuda(q, k, v, 1 / math.sqrt(128)))
    if keys > 64:
        dropped = _tile_dropped(q, k, v, gm.global_match_cuda)
        assert float((dropped - want).abs().max()) > bar


@pytest.mark.card
def test_gmflow_replay_is_the_eager_forward(cuda):
    model = entry.build_model(GMFlowConfig(compute_dtype="bfloat16"), "cuda",
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
