"""The serving entry (``models/entry.py``): its place above both
networks, the one rule by which it and the packed and merged convs notice
new parameters, its graph's key, the reasons to stay eager, the cache's
bound, and on the card a replay bit for bit the eager forward, also for
two threads at one key.

The CPU tests hold the plain functions; the tests marked ``card`` need a
CUDA device and skip without one.  On the card, without the JAX
configuration of ``tests/conftest.py``:

    python -m pytest tests/test_torch_port_entry_graph.py -m card \\
        --noconftest -p no:cacheprovider -q
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.checkpoint.npz_io import load_npz_flat
from upflow_pytorch_tpu_torch.config import RAFTConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.models import entry, upflow
from upflow_pytorch_tpu_torch.models.occlusion import occ_check
from upflow_pytorch_tpu_torch.ops import warp as pwarp
from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg
from upflow_pytorch_tpu_torch.ops.resize import fp32_numerics
from upflow_pytorch_tpu_torch.utils.misc import nhwc

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
CPU = torch.device("cpu")
EVAL_KNOBS = dict(if_norm_before_cost_volume=True,
                  norm_moments_across_channels=False,
                  norm_moments_across_images=False, if_sgu_upsample=True)
BF16_SGU = dict(EVAL_KNOBS, compute_dtype="bfloat16")
FP32_PLAIN = dict(EVAL_KNOBS, if_sgu_upsample=False)
SPANS = ["upflow.forward", "upflow.copy_in", "upflow.pyramid"] + [
    "upflow.level.%d" % i for i in range(5)] + [
    "upflow.upsample", "upflow.occlusion", "upflow.copy_out"]


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


def _counts():
    f = entry.forward
    return f.graph_captures, f.graph_replays, dict(f.eager_calls)


@pytest.fixture(scope="module")
def cpu_model():
    return entry.build_model(UPFlowConfig().updated(EVAL_KNOBS), "cpu",
                             weights=NPZ)


# --- the layering ------------------------------------------------------------

PACKAGE = "upflow_pytorch_tpu_torch"
# module -> the modules of the package that importing it must not load
LAYERS = {"models.entry": ("models.upflow", "models.raft", "models.gmflow"),
          "models.upflow": ("models.raft", "models.gmflow"),
          "checkpoint.state_io": ("models",),
          "utils.misc": ("models",)}


@pytest.mark.parametrize("module", sorted(LAYERS))
def test_layering(module):
    """The entry sits above the three networks and loads none, UPFlow's
    module loads neither RAFT's nor GMFlow's, and the checkpoint and device
    helpers load no network module: each imported alone, in a fresh
    process."""
    code = ("import importlib, sys; importlib.import_module(%r); "
            "print(' '.join(sys.modules))" % (PACKAGE + "." + module))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    loaded = [m[len(PACKAGE) + 1:] for m in run.stdout.split()
              if m.startswith(PACKAGE + ".")]
    assert module in loaded
    assert not [m for m in loaded if m.startswith(LAYERS[module])]


def test_the_benchmark_names_are_the_entry():
    assert upflow.forward is entry.forward
    assert upflow.build_model is entry.build_model


# --- the key -----------------------------------------------------------------

# (what changes, how): each must give another key
KEY_CHANGES = {
    "height": lambda m, s: (m, (1, 64, 80, 3), s[1]),
    "batch": lambda m, s: (m, (2,) + s[0][1:], (2,) + s[1][1:]),
    "second_image": lambda m, s: (m, s[0], (1, 64, 80, 3)),
    "compute_dtype": lambda m, s: (entry.build_model(
        UPFlowConfig().updated(BF16_SGU), "cpu"), s[0], s[1]),
    "sgu": lambda m, s: (entry.build_model(
        UPFlowConfig().updated(FP32_PLAIN), "cpu"), s[0], s[1]),
    "cost_volume": lambda m, s: (entry.build_model(
        UPFlowConfig().updated(dict(EVAL_KNOBS, if_use_cor_pytorch=True)),
        "cpu"), s[0], s[1]),
}
SWITCHES = {
    "mask_threshold": lambda mp: mp.setattr(pwarp, "MASK_THRESHOLD", 0.9999),
    "robust_mask": lambda mp: mp.setenv("UPFLOW_ROBUST_MASK", "1"),
    "cudnn_enabled": lambda mp: mp.setattr(
        torch.backends.cudnn, "enabled", not torch.backends.cudnn.enabled),
    "cudnn_benchmark": lambda mp: mp.setattr(
        torch.backends.cudnn, "benchmark",
        not torch.backends.cudnn.benchmark),
    "cudnn_deterministic": lambda mp: mp.setattr(
        torch.backends.cudnn, "deterministic",
        not torch.backends.cudnn.deterministic),
    "deterministic_algorithms": lambda mp: mp.setattr(
        torch, "are_deterministic_algorithms_enabled", lambda: True),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_key_changes_with_the_call(cpu_model, change):
    shapes = ((1, 64, 96, 3), (1, 64, 96, 3))
    before = entry.graph_key(cpu_model, *shapes, CPU)
    model, s1, s2 = KEY_CHANGES[change](cpu_model, shapes)
    assert entry.graph_key(model, s1, s2, CPU) != before


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_key_changes_with_a_switch(cpu_model, switch, monkeypatch):
    monkeypatch.delenv("UPFLOW_ROBUST_MASK", raising=False)
    shapes = ((1, 64, 96, 3), (1, 64, 96, 3))
    before = entry.graph_key(cpu_model, *shapes, CPU)
    SWITCHES[switch](monkeypatch)
    after = entry.graph_key(cpu_model, *shapes, CPU)
    assert after != before and after[1] == before[1]


def test_key_stays_for_the_same_call(cpu_model):
    """New images of the same shapes, and a forward between, leave the key
    as it was."""
    im1, im2 = _images(1, 64, 96, 0)
    key = entry.graph_key(cpu_model, im1.shape, im2.shape, CPU)
    entry.forward(cpu_model, im1, im2)
    im1, im2 = _images(1, 64, 96, 1)
    assert entry.graph_key(cpu_model, im1.shape, im2.shape, CPU) == key
    assert entry.graph_key(cpu_model, torch.from_numpy(im1).shape,
                           im2.shape, CPU) == key


# --- the parameter-change rule ---------------------------------------------

def _packed(model):
    """A dense-stack conv's packed weights and fp32 bias, as held and as a
    fresh pack gives them."""
    block = model.flow_estimators.conv1
    return (seg.packed_params(block, block[0].weight, block[0].bias),
            (seg.pack_weight(block[0].weight), block[0].bias.float()))


def _merged(model):
    """RAFT's merged head convs, as held and as a fresh concatenation gives
    them."""
    heads = model.update_block.heads
    return heads.params(), tuple(
        torch.cat([getattr(c, name) for c in heads.layers])
        for name in ("weight", "bias"))


def _key(model):
    return entry.graph_key(model, (1, 64, 96, 3), (1, 64, 96, 3), CPU), None


# user -> (its network, the conv an update changes, what the rule keeps)
RULE_USERS = {
    "packed_conv": ("upflow", lambda m: m.flow_estimators.conv1[0], _packed),
    "merged_conv": ("raft", lambda m: m.update_block.heads.layers[1],
                    _merged),
    "graph_key": ("upflow", lambda m: m.flow_estimators.conv1[0], _key)}
RULE_UPDATES = ("copy_", "load_state_dict", "bias", "to", "data",
                "params_from_jax")
# the updates that leave every value as it was: new storage alone
SAME_VALUES = ("to", "data")


def _rule_model(net, seed):
    conf = (RAFTConfig(iters=1) if net == "raft"
            else UPFlowConfig().updated(BF16_SGU))
    return entry.build_model(conf, "cpu", seed=seed)


def _update(update, net, model, conv):
    with torch.no_grad():
        if update == "copy_":
            conv.weight.copy_(torch.randn(
                conv.weight.shape, generator=torch.Generator().manual_seed(3)))
        elif update == "load_state_dict":
            model.load_state_dict(_rule_model(net, seed=1).state_dict())
        elif update == "bias":
            conv.bias.add_(1.0)
        elif update == "to":
            model.to(torch.float64).to(torch.float32)
        elif update == "data":
            conv.weight.data = conv.weight.data.clone()
        else:
            model.load_state_dict(params_from_jax(
                load_npz_flat(NPZ), model.state_dict().keys()))


@pytest.mark.parametrize("user,update", [
    (user, update) for user in sorted(RULE_USERS) for update in RULE_UPDATES
    if not (update == "params_from_jax" and RULE_USERS[user][0] == "raft")])
def test_a_parameter_change_is_noticed(user, update):
    """Each user of ``_common.py::param_versions`` notices each way the
    parameters change, in place (``copy_``, ``load_state_dict``, the bias
    alone, ``params_from_jax``) or by new storage (``.to()``, a ``.data``
    swap): the packed and merged convs are rebuilt, equal to a fresh
    build from the new parameters, and then kept; the graph key's weights
    part changes, its call part does not, and the model's graphs go."""
    net, conv_of, kept = RULE_USERS[user]
    model = _rule_model(net, seed=0)
    held, _ = kept(model)
    # the values held before (the fp32 bias is the parameter itself)
    before = None if user == "graph_key" else [t.clone() for t in held]
    # the old storage stays alive, so that no new tensor can take its
    # address
    old_storage = [p.data for p in model.parameters()]
    _update(update, net, model, conv_of(model))
    del old_storage
    now, fresh = kept(model)
    if user == "graph_key":
        assert now[0] == held[0] and now[1] != held[1]
        cache = entry.GraphCache()
        cache.take(held)
        cache.entries[held] = "graph"
        assert cache.take(now) == (False, None)
        assert list(cache.entries) == [now]
        return
    assert now is not held and kept(model)[0] is now
    assert all(torch.equal(a, b) for a, b in zip(now, fresh))
    same = all(torch.equal(a, b) for a, b in zip(now, before))
    assert same == (update in SAME_VALUES)


# --- the reasons to stay eager ---------------------------------------------

def _module_hook(model):
    return model.conv_1x1[0].register_forward_hook(lambda *a: None)


def _module_pre_hook(model):
    return model.sgi_model.register_forward_pre_hook(lambda *a: None)


def _global_hook(model):
    return torch.nn.modules.module.register_module_forward_hook(
        lambda *a: None)


def _global_pre_hook(model):
    return torch.nn.modules.module.register_module_forward_pre_hook(
        lambda *a: None)


@pytest.mark.parametrize("hook", [_module_hook, _module_pre_hook,
                                  _global_hook, _global_pre_hook])
def test_hooks_keep_the_entry_eager(cpu_model, hook):
    cuda = torch.device("cuda", 0)
    assert entry.eager_reason(cpu_model, cuda) is None
    handle = hook(cpu_model)
    try:
        assert entry.eager_reason(cpu_model, cuda) == "hooks"
    finally:
        handle.remove()
    assert entry.eager_reason(cpu_model, cuda) is None


def test_each_reason_is_reported(cpu_model):
    """cpu, shard, eager_entry and profiler, each beside a clean card
    call (None); ``eager_entry`` nests."""
    cuda = torch.device("cuda", 0)
    assert entry.eager_reason(cpu_model, CPU) == "cpu"
    assert entry.eager_reason(cpu_model, CPU, shard=object()) == "cpu"
    assert entry.eager_reason(cpu_model, cuda, shard=object()) == "shard"
    with entry.eager_entry():
        with entry.eager_entry():
            assert entry.eager_reason(cpu_model, cuda) == "eager_entry"
        assert entry.eager_reason(cpu_model, cuda) == "eager_entry"
    assert entry.eager_reason(cpu_model, cuda) is None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert entry.eager_reason(cpu_model, cuda) == "profiler"
    assert entry.eager_reason(cpu_model, cuda) is None
    assert set(entry.forward.eager_calls) == set(entry.EAGER_REASONS)


# --- the cache ---------------------------------------------------------------

def test_cache_first_call_then_capture_then_replay():
    cache = entry.GraphCache(size=2)
    key = (("a",), ("w",))
    assert cache.take(key) == (False, None)
    assert cache.take(key) == (True, None)
    cache.entries[key] = "graph"
    assert cache.take(key) == (True, "graph")


def test_cache_evicts_the_least_recently_used_key():
    cache = entry.GraphCache(size=2)
    a, b, c = (((n,), ("w",)) for n in "abc")
    for key in (a, b):
        cache.take(key)
        cache.entries[key] = "graph " + key[0][0]
    assert cache.take(a) == (True, "graph a")  # b is now the oldest
    assert cache.take(c) == (False, None)
    assert list(cache.entries) == [a, c]
    assert cache.take(b) == (False, None)  # evicted: a first call again
    assert list(cache.entries) == [c, b]
    assert entry.GraphCache().size == entry.GRAPH_KEYS


def test_cache_empties_on_other_weights():
    cache = entry.GraphCache()
    for n in "ab":
        cache.take(((n,), ("w1",)))
        cache.entries[(n,), ("w1",)] = n
    assert cache.take((("a",), ("w2",))) == (False, None)
    assert list(cache.entries) == [(("a",), ("w2",))]


# --- the CPU forward ---------------------------------------------------------

def test_cpu_forward_is_the_eager_composition(cpu_model):
    """A CPU forward is bit for bit the network, the occlusion check and
    the NHWC layout run op by op, counted as an eager call for "cpu", and
    keeps no graph cache."""
    im1, im2 = _images(1, 64, 96, 2)
    before = _counts()
    out = entry.forward(cpu_model, im1, im2)
    after = _counts()
    conf = cpu_model.conf
    t1 = torch.from_numpy(im1).permute(0, 3, 1, 2).contiguous()
    t2 = torch.from_numpy(im2).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad(), fp32_numerics():
        flow_f, flow_b, flows = cpu_model(t1, t2)
        occ_fw, occ_bw = occ_check(flow_f, flow_b, conf.alpha_1,
                                   conf.alpha_2, conf.occ_check_obj_out_all,
                                   conf.occ_type)
    want = {"flow_f_out": nhwc(flow_f), "flow_b_out": nhwc(flow_b),
            "occ_fw": nhwc(occ_fw), "occ_bw": nhwc(occ_bw),
            "flows": [(nhwc(f), nhwc(b)) for f, b in flows]}
    assert _bit_equal(out, want)
    assert after[:2] == before[:2]
    assert after[2]["cpu"] == before[2]["cpu"] + 1
    assert sum(after[2].values()) == sum(before[2].values()) + 1
    assert "_entry_graphs" not in cpu_model.__dict__


def test_keeping_constants_lists_the_lookups():
    from upflow_pytorch_tpu_torch.ops import resize

    x = torch.rand(1, 2, 5, 7)
    resize.resize_bilinear_align_corners(x, (9, 13))
    with resize.keeping_constants() as kept:
        y = resize.resize_bilinear_align_corners(x, (9, 13))
        idx, wt = resize.interp_taps(9, 5, CPU)
    assert [tuple(t.shape) for t in kept[:2]] == [(9, 5), (13, 7)]
    assert kept[2] == (idx, wt)
    assert resize._kept is None
    assert torch.equal(y, resize.resize_bilinear_align_corners(x, (9, 13)))


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see the module "
                    "docstring)")
    return torch.device("cuda", 0)


def _card_model(knobs):
    return entry.build_model(UPFlowConfig().updated(knobs), "cuda",
                             weights=NPZ)


def _eager(model, im1, im2):
    with entry.eager_entry():
        return entry.forward(model, im1, im2)


@pytest.mark.card
@pytest.mark.parametrize("knobs,shape", [
    (BF16_SGU, (1, 375, 1242)), (FP32_PLAIN, (1, 96, 160)),
    (BF16_SGU, (2, 384, 1280))], ids=["bf16_sgu_b1", "fp32_b1", "bf16_sgu_b2"])
def test_replay_is_the_eager_forward(cuda, knobs, shape):
    """At one key: an eager first call, a capture, replays; each bit for
    bit the eager forward of its own images, whichever images the graph
    was captured with."""
    model = _card_model(knobs)
    a, b = _images(*shape, 10), _images(*shape, 11)
    want = {"a": _eager(model, *a), "b": _eager(model, *b)}
    c0 = _counts()
    got = [entry.forward(model, *pair) for pair in (a, b, a, b)]
    torch.cuda.synchronize()
    c1 = _counts()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 2)
    assert c1[2]["first_at_key"] == c0[2]["first_at_key"] + 1
    for out, name in zip(got, "abab"):
        assert _bit_equal(out, want[name])
    assert all(t.is_cuda and t.dtype == torch.float32
               for out in got for t in _outputs(out))


@pytest.mark.card
def test_returned_tensors_outlive_the_next_request(cuda):
    model = _card_model(FP32_PLAIN)
    a, b = _images(1, 96, 160, 12), _images(1, 96, 160, 13)
    for pair in (a, b):
        entry.forward(model, *pair)  # the first call, then the capture
    out_a = entry.forward(model, *a)
    kept = [t.clone() for t in _outputs(out_a)]
    out_b = entry.forward(model, *b)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(_outputs(out_a), kept))
    assert not torch.equal(out_a["flow_f_out"], out_b["flow_f_out"])
    assert all(x.data_ptr() != y.data_ptr()
               for x, y in zip(_outputs(out_a), _outputs(out_b)))


@pytest.mark.card
def test_new_weights_recapture(cuda):
    """An in-place change of a ``conv3x3_seg`` conv's weights: the next
    call runs eagerly (and repacks), the one after captures anew, and the
    replays are bit for bit the eager forward of the new weights."""
    model = _card_model(BF16_SGU)
    a = _images(1, 128, 256, 14)
    for _ in range(3):
        entry.forward(model, *a)
    weight = model.flow_estimators.conv1[0].weight
    with torch.no_grad():
        weight.mul_(1.5)
    c0, packs = _counts(), seg.pack_weight.calls
    got = [entry.forward(model, *a) for _ in range(3)]
    c1, packs = _counts(), seg.pack_weight.calls - packs
    assert packs == 1  # the changed conv, at the eager call
    assert c1[2]["first_at_key"] == c0[2]["first_at_key"] + 1
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 1)
    want = _eager(model, *a)
    assert all(_bit_equal(out, want) for out in got)
    assert len(model._entry_graphs.entries) == 1


@pytest.mark.card
def test_hooks_and_the_profiler_run_eagerly(cuda):
    """Under a forward hook the hook runs at every call; under a profiler
    every ``upflow.*`` span of the entry is recorded.  Both calls are
    eager and bit for bit the replay."""
    from torch.profiler import ProfilerActivity, profile

    model = _card_model(BF16_SGU)
    a = _images(1, 128, 256, 15)
    for _ in range(3):
        replay = entry.forward(model, *a)
    heads = []
    handle = model.sgi_model.dense_estimator_mask.register_forward_hook(
        lambda mod, args, out: heads.append(out))
    c0 = _counts()
    try:
        hooked = entry.forward(model, *a)
    finally:
        handle.remove()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = entry.forward(model, *a)
        torch.cuda.synchronize()
    c1 = _counts()
    assert len(heads) == 10  # two directions at levels 1-4 and the final
    assert c1[2]["hooks"] == c0[2]["hooks"] + 1
    assert c1[2]["profiler"] == c0[2]["profiler"] + 1
    assert c1[:2] == c0[:2]
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names
    assert _bit_equal(hooked, replay) and _bit_equal(profiled, replay)


@pytest.mark.card
def test_two_threads_at_one_key(cuda):
    """Two threads serve different pairs at one key from one graph, the
    interpreter switching threads as often as it can: the model's lock
    keeps each call's copy in, replay and clones together, so every
    output is bit for bit the eager forward of its own pair."""
    model = _card_model(BF16_SGU)
    pairs = [_images(1, 128, 256, 16), _images(1, 128, 256, 17)]
    want = [_eager(model, *pair) for pair in pairs]
    for pair in pairs:
        entry.forward(model, *pair)  # the first call, then the capture
    reps, got, errors = 20, [[], []], []

    def serve(i):
        try:
            for _ in range(reps):
                got[i].append(entry.forward(model, *pairs[i]))
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    c0 = _counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    c1 = _counts()
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (0, 2 * reps)
    for i in range(2):
        assert len(got[i]) == reps
        assert all(_bit_equal(out, want[i]) for out in got[i])
