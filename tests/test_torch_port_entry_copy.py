"""The serving entry's copy in (``models/entry.py``): the route a call's
images take, the counter of routes,
and on the card outputs bit for bit those of images already on the card,
the caller's arrays free once a call returns, calls queued back to back,
and no new pinned memory after warm-up.

The CPU tests hold the plain functions; the tests marked ``card`` need a
CUDA device and skip without one.  On the card, without the JAX
configuration of ``tests/conftest.py``:

    python -m pytest tests/test_torch_port_entry_copy.py -m card \\
        --noconftest -p no:cacheprovider -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from upflow_pytorch_tpu_torch.config import RAFTConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.models import entry

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)
BF16_SGU = dict(if_norm_before_cost_volume=True,
                norm_moments_across_channels=False,
                norm_moments_across_images=False, if_sgu_upsample=True,
                compute_dtype="bfloat16")


def _images(b, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


def _outputs(out):
    """The outputs as a flat list, in a fixed order."""
    return [out[k] for k in ("flow_f_out", "flow_b_out", "occ_fw",
                             "occ_bw")] + [t for pair in out["flows"]
                                           for t in pair]


def _bit_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(_outputs(a), _outputs(b)))


# --- the route ---------------------------------------------------------------

def _nbytes(b, h, w):
    return b * h * w * 3 * 4  # one NHWC fp32 image batch


def _host(b=16, h=384, w=1280, dtype=torch.float32):
    """Host NHWC images, not written: the route reads their metadata."""
    return torch.empty(b, h, w, 3, dtype=dtype)


B1 = (1, 375, 1242)  # a KITTI frame, below the threshold
B4 = (4, 384, 1280)  # above it
MIN_PIXELS = entry.STAGE_MIN_BYTES // 12  # NHWC fp32 pixels at the threshold


# name -> (the model's device, the images, the route)
ROUTES = {
    "b16_to_card": (CUDA, lambda: [_host(), _host()], "staged"),
    "b4_to_card": (CUDA, lambda: [_host(*B4), _host(*B4)], "staged"),
    "b2_to_card": (CUDA, lambda: [_host(2, 384, 1280)] * 2, "plain"),
    "raft_b4_to_card": (CUDA, lambda: [_host(4, 375, 1242)] * 2, "staged"),
    "b1_to_card": (CUDA, lambda: [_host(*B1), _host(*B1)], "plain"),
    "b1_384x1280_to_card": (CUDA, lambda: [_host(1, 384, 1280)] * 2,
                            "plain"),
    "at_the_threshold": (CUDA, lambda: [_host(1, 1, MIN_PIXELS)], "plain"),
    "a_pixel_over": (CUDA, lambda: [_host(1, 1, MIN_PIXELS + 1)], "staged"),
    "one_of_two_small": (CUDA, lambda: [_host(), _host(*B1)], "plain"),
    "non_contiguous": (CUDA, lambda: [_host()[:, :, ::2], _host()], "plain"),
    "nchw_view": (CUDA, lambda: [_host().permute(0, 3, 1, 2)], "plain"),
    "fp64": (CUDA, lambda: [_host(dtype=torch.float64)], "plain"),
    "uint8": (CUDA, lambda: [_host(dtype=torch.uint8)], "plain"),
    "bf16": (CUDA, lambda: [_host(dtype=torch.bfloat16)], "plain"),
    "on_another_device": (CUDA, lambda: [
        torch.empty(16, 384, 1280, 3, device="meta")], "plain"),
    "one_of_two_fp64": (CUDA, lambda: [_host(), _host(dtype=torch.float64)],
                        "plain"),
    "cpu_model_fp32": (CPU, lambda: [_host(), _host()], "on_device"),
    "cpu_model_fp64": (CPU, lambda: [_host(dtype=torch.float64)],
                       "on_device"),
    "cpu_model_non_contiguous": (CPU, lambda: [_host()[:, ::2]],
                                 "on_device"),
    "already_there": (torch.device("meta"), lambda: [
        torch.empty(16, 384, 1280, 3, device="meta")], "on_device"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_the_route_follows_the_input(case):
    device, images, route = ROUTES[case]
    assert entry.input_route(device, *images()) == route
    assert route in entry.INPUT_ROUTES


def test_a_cpu_model_call_is_counted():
    model = entry.build_model(UPFlowConfig().updated(BF16_SGU), "cpu",
                              weights=NPZ)
    before = dict(entry.forward.input_copies)
    entry.forward(model, *_images(1, 64, 96, 1))
    after = dict(entry.forward.input_copies)
    assert set(after) == set(entry.INPUT_ROUTES)
    assert {k: after[k] - before[k] for k in after} == {
        "staged": 0, "plain": 0, "on_device": 1}


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see the module "
                    "docstring)")
    return CUDA


def _model(net):
    if net == "raft":
        return entry.build_model(RAFTConfig(compute_dtype="bfloat16"), "cuda")
    return entry.build_model(UPFlowConfig().updated(BF16_SGU), "cuda",
                             weights=NPZ)


def _eager(model, im1, im2):
    with entry.eager_entry():
        return entry.forward(model, im1, im2)


def _on_card(pair):
    """Today's composition of the copy: the images on the card first."""
    return [torch.as_tensor(x).to(CUDA) for x in pair]


@pytest.mark.card
@pytest.mark.parametrize("nbytes", [
    _nbytes(1, 375, 1242), _nbytes(2, 384, 1280), _nbytes(16, 384, 1280),
    entry.STAGE_MIN_BYTES + 4, 4])
def test_staged_copy_is_copy(cuda, nbytes):
    """``staged_copy`` of any size leaves the card tensor bit for bit the
    host tensor."""
    src = torch.from_numpy(np.random.RandomState(nbytes % 1000).rand(
        nbytes // 4).astype(np.float32))
    dst = torch.full((nbytes // 4,), float("nan"), device=cuda)
    entry.staged_copy(src, dst)
    assert torch.equal(dst.cpu(), src)


@pytest.mark.card
@pytest.mark.parametrize("net,shape,route", [
    ("upflow", (1, 375, 1242), "plain"), ("upflow", (4, 384, 1280), "staged"),
    ("upflow", (16, 384, 1280), "staged"), ("raft", (1, 375, 1242), "plain"),
    ("raft", (4, 375, 1242), "staged")],
    ids=["upflow_bf16_sgu_b1", "upflow_bf16_sgu_b4", "upflow_bf16_sgu_b16",
         "raft_bf16_b1", "raft_bf16_b4"])
def test_the_copy_in_is_the_plain_copy(cuda, net, shape, route):
    """Eagerly and from the graph (first call, capture, replays), a call
    on host arrays is bit for bit the call on the same images put on the
    card by ``torch.as_tensor(a).to(device)``, and counts one copy in a
    call on its route."""
    model = _model(net)
    pair = _images(*shape, 20)
    want = _eager(model, *_on_card(pair))
    c0 = entry.forward.input_copies[route]
    got = [_eager(model, *pair)] + [entry.forward(model, *pair)
                                    for _ in range(4)]
    torch.cuda.synchronize()
    assert entry.forward.input_copies[route] - c0 == len(got)
    assert all(_bit_equal(out, want) for out in got)
    assert model._entry_graphs.entries  # the graph served the last calls


@pytest.mark.card
@pytest.mark.parametrize("eager", [True, False], ids=["eager", "graph"])
def test_the_caller_may_overwrite_its_arrays(cuda, eager):
    """The caller writes new values into its arrays the moment a call
    returns, before the card has finished: the outputs are still those of
    the values it passed."""
    model = _model("upflow")
    a, b = _images(*B4, 21), _images(*B4, 22)
    want = _eager(model, *a)
    call = _eager if eager else entry.forward
    for _ in range(2):  # the first call, then the capture
        call(model, *[x.copy() for x in a])
    im1, im2 = (x.copy() for x in a)
    out = call(model, im1, im2)
    im1[...], im2[...] = b
    torch.cuda.synchronize()
    assert _bit_equal(out, want)


@pytest.mark.card
def test_back_to_back_calls_keep_their_own_inputs(cuda):
    """Calls on different pairs issued without a synchronise between them,
    eagerly and from the graph: each returns its own pair's outputs."""
    model = _model("upflow")
    pairs = [_images(*B4, 23 + i) for i in range(3)]
    want = [_eager(model, *pair) for pair in pairs]
    torch.cuda.synchronize()
    got = [_eager(model, *pair) for pair in pairs]
    got += [entry.forward(model, *pair) for _ in range(3) for pair in pairs]
    torch.cuda.synchronize()
    assert all(_bit_equal(out, want[i % 3]) for i, out in enumerate(got))


@pytest.mark.card
@pytest.mark.parametrize("shape", [B4, (16, 384, 1280)], ids=["b4", "b16"])
def test_no_new_pinned_memory_after_warm_up(cuda, shape):
    """After warm-up, a window of requests served as the benchmark serves
    them (a synchronise after each) takes its staging buffers from the
    caching host allocator: no new page-locked allocation."""
    model = _model("upflow")
    pairs = [_images(*shape, 30 + i) for i in range(2)]
    for i in range(4):
        entry.forward(model, *pairs[i % 2])
        torch.cuda.synchronize()
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    s0 = entry.forward.input_copies["staged"]
    for i in range(8):
        entry.forward(model, *pairs[i % 2])
        torch.cuda.synchronize()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert entry.forward.input_copies["staged"] - s0 == 8
