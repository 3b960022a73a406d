"""The serving entry of the three networks: ``build_model`` builds
``models/upflow.py::UPFlowNet``, ``models/raft.py::RAFTNet`` or
``models/gmflow.py::GMFlowNet`` from its configuration, and ``forward``
serves each the same way (the copy in, the network, the occlusion check
that its configuration names as ``occlusion``, NHWC outputs, counters and
spans), on the card from one CUDA graph per ``graph_key``
(``EntryGraph``): bit for bit the eager forward.  The caller's host images reach the card by
``input_route``: large contiguous fp32 ones through pinned memory
(``staged_copy``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import (
    TYPE_CHECKING, Any, Dict, Iterator, Optional, Sequence, Tuple, Union)

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.nn.modules import module as _nn_module

from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.checkpoint.npz_io import load_npz_flat
from upflow_pytorch_tpu_torch.config import (
    GMFlowConfig, RAFTConfig, UPFlowConfig)
from upflow_pytorch_tpu_torch.models.occlusion import occ_check
from upflow_pytorch_tpu_torch.ops import warp as _warp
from upflow_pytorch_tpu_torch.ops.kernels._common import param_versions
from upflow_pytorch_tpu_torch.ops.resize import (
    fp32_numerics, keeping_constants)
from upflow_pytorch_tpu_torch.utils.misc import (
    as_nchw, host_tensor, nhwc, resolve_device)
from upflow_pytorch_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from upflow_pytorch_tpu_torch.models.gmflow import GMFlowNet
    from upflow_pytorch_tpu_torch.models.raft import RAFTNet
    from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet
    from upflow_pytorch_tpu_torch.parallel.spatial import WidthShard

Net = Union["UPFlowNet", "RAFTNet", "GMFlowNet"]  # what the entry serves
Config = Union[UPFlowConfig, RAFTConfig, GMFlowConfig]


def build_model(conf: Config = UPFlowConfig(),
                device=None, weights: Optional[str] = None,
                seed: int = 0) -> Net:
    """The network in eval mode on ``device`` (CUDA unless ``"cpu"`` is
    asked for).  Weights: Kaiming-normal from a ``torch.Generator`` seeded
    with ``seed``, or, with ``weights``, a JAX ``.npz`` snapshot (such as
    ``assets/synthetic_trained.npz``) loaded strictly through
    ``params_from_jax``; snapshot entries the model lacks (the SGU
    weights, when it is built without SGU) are listed in
    ``model.skipped_keys``.

    A ``RAFTConfig`` builds ``RAFTNet`` with RAFT's initialisation from
    the seed (``models/raft.py::init_weights``), or with ``weights`` a
    RAFT state dict saved by ``torch.save``, such as a published
    checkpoint.  A ``GMFlowConfig`` builds ``GMFlowNet`` the same way,
    with GMFlow's initialisation (``models/gmflow.py::init_weights``) or
    a GMFlow state dict; its 'float32' runs on the CPU alone, and a card
    raises a ``ValueError`` here."""
    device = resolve_device(device)
    if isinstance(conf, GMFlowConfig):
        if device.type != "cpu" and conf.compute_dtype != "bfloat16":
            raise ValueError("GMFlow serves %s on the CPU alone: the card's "
                             "global_match takes bf16 (compute_dtype="
                             "'bfloat16')" % conf.compute_dtype)
        from upflow_pytorch_tpu_torch.models import gmflow

        model = gmflow.GMFlowNet(conf, torch.Generator().manual_seed(seed))
        if weights is not None:
            gmflow.load_state(model, weights)
        return model.to(device).eval()
    if isinstance(conf, RAFTConfig):
        from upflow_pytorch_tpu_torch.models.raft import RAFTNet, load_state

        model = RAFTNet(conf, torch.Generator().manual_seed(seed))
        if weights is not None:
            load_state(model, weights)
        return model.to(device).eval()
    from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet

    model = UPFlowNet(conf, torch.Generator().manual_seed(seed))
    model.skipped_keys = []
    if weights is not None:
        sd = params_from_jax(load_npz_flat(weights),
                             model.state_dict().keys(), model.skipped_keys)
        model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


STAGE_MIN_BYTES = 16 << 20  # images above this size are staged
INPUT_ROUTES = ("staged", "plain", "on_device")


def input_route(device: torch.device, *images: torch.Tensor) -> str:
    """How ``forward`` brings ``images`` (tensors, on the host or a device)
    to the model's ``device``, one of ``INPUT_ROUTES``: "on_device" where
    all are there already (any host input of a CPU model), not copied;
    "staged" where the device is a card and all are contiguous fp32 host
    tensors of more than ``STAGE_MIN_BYTES`` (``staged_copy``); else
    "plain", each by ``copy_`` or ``.to(device, float32)``, which converts
    and gathers it as it is.  On an H100's host a B=16 384x1280 request is
    served faster staged and a B=1 375x1242 one slower: the CPU copy wakes
    torch's threads after the card's work, which stalls it by several ms
    at times (B=1: p95 +7 ms), a cost that only a large copy repays."""
    if all(x.device == device for x in images):
        return "on_device"
    if device.type == "cuda" and all(
            x.device.type == "cpu" and x.dtype == torch.float32
            and x.is_contiguous() and x.nbytes > STAGE_MIN_BYTES
            for x in images):
        return "staged"
    return "plain"


def staged_copy(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)`` for a host ``src`` and a card tensor ``dst`` of
    its dtype and size, through page-locked memory: torch's CPU copy (over
    the intra-op threads) into a buffer of the caching host allocator, then
    its DMA queued on the current stream, so the host stages the next image
    while the copy engine moves this one.  ``src`` is read in full before
    the return.  The DMA records an event on the buffer, which keeps the
    allocator from handing it out again before the DMA has finished."""
    return dst.copy_(src.pin_memory(), non_blocking=True)


GRAPH_KEYS = 8  # keys a model keeps graphs for: KITTI's frame sizes and more
EAGER_REASONS = ("first_at_key", "cpu", "shard", "hooks", "profiler",
                 "eager_entry")

_eager_blocks = 0  # ``eager_entry`` blocks open


@contextlib.contextmanager
def eager_entry() -> Iterator[None]:
    """``forward`` runs eagerly in the block, never from a graph: for
    callers that swap the program's functions, which a replay would
    ignore, or that read the kernels' launch counters around a forward,
    which count in Python, so at a capture and not at a replay."""
    global _eager_blocks
    _eager_blocks += 1
    try:
        yield
    finally:
        _eager_blocks -= 1


def eager_reason(model: Net, device: torch.device,
                 shard: Optional[WidthShard] = None) -> Optional[str]:
    """Why ``forward`` must run ``model`` eagerly on ``device`` (one of
    ``EAGER_REASONS``), or None where a graph may serve the call: no CUDA
    device ("cpu"); a width shard, whose ``Columns`` the ops read on the
    host ("shard"); an ``eager_entry()`` block; a torch profiler
    recording, whose traces time the kernels one launch at a time, under
    the program's spans and its Python calls ("profiler"); a forward hook
    or pre-hook on one of the model's modules, or a global one, which a
    replay would not call ("hooks")."""
    if device.type != "cuda":
        return "cpu"
    if shard is not None:
        return "shard"
    if _eager_blocks:
        return "eager_entry"
    if _autograd_profiler._is_profiler_enabled:
        return "profiler"
    if (_nn_module._global_forward_hooks
            or _nn_module._global_forward_pre_hooks
            or any(m._forward_hooks or m._forward_pre_hooks
                   for m in model.modules())):
        return "hooks"
    return None


def graph_key(model: Net, shape1: Sequence[int],
              shape2: Sequence[int], device: torch.device
              ) -> Tuple[tuple, tuple]:
    """What the captured work depends on that a call can observe, as (the
    call's part, the weights' part): the images' shapes and the device;
    the configuration (compute dtype, SGU, cost volume); the warp mask's
    threshold; cuDNN's switches and torch's deterministic algorithms; and
    the parameters' ``param_versions``, the rule by which the packed and
    merged convs notice new weights (their copies are made on the host,
    outside any replay)."""
    cudnn = torch.backends.cudnn
    call = (tuple(shape1), tuple(shape2), device.index, model.conf,
            _warp.mask_threshold(), cudnn.enabled, cudnn.benchmark,
            cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    return call, param_versions(model.parameters())


class GraphCache:
    """The graphs ``forward`` keeps on a model, by ``graph_key``: at most
    ``size`` keys, the least recently used out first.  A key's first call
    stores None (it runs eagerly), its second the captured graph
    (``forward`` puts it in ``entries``).  A key of other weights empties
    the cache: its graphs read the old weights' packed copies, which are
    gone or stale.  ``lock`` is held from ``take`` to a graph's clones:
    its inputs and outputs are one buffer for every thread."""

    def __init__(self, size: int = GRAPH_KEYS):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.lock = threading.Lock()

    def take(self, key: Tuple[tuple, tuple]) -> Tuple[bool, Any]:
        """(whether ``key`` was met before, its graph or None), the key
        now the most recently used; a new key is stored with None."""
        entries = self.entries
        if entries and next(iter(entries))[1] != key[1]:
            entries.clear()
        if key in entries:
            entries.move_to_end(key)
            return True, entries[key]
        entries[key] = None
        while len(entries) > self.size:
            entries.popitem(last=False)
        return False, None


class EntryGraph:
    """One request's device work as a CUDA graph: the NHWC fp32 images in
    static buffers, their NCHW layout, the network, the occlusion check and
    the NHWC outputs.  Captured on a side stream after an eager call at the
    same key has packed the weights, filled ``ops/resize.py``'s caches, set
    the kernels' attributes and let cuDNN pick its plans; it holds the
    device constants it reads.  A call copies the images into the static
    buffers by their ``input_route``, replays on the current stream behind
    the copies and returns clones of the outputs."""

    def __init__(self, model: Net, shape1: Sequence[int],
                 shape2: Sequence[int], device: torch.device):
        self.device = device
        self.im1, self.im2 = (torch.empty(tuple(s), dtype=torch.float32,
                                          device=device)
                              for s in (shape1, shape2))
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(stream), \
                keeping_constants() as self.constants:
            # other threads (a loader's copies) may use the device meanwhile
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = _outputs(model, as_nchw(self.im1, device),
                                    as_nchw(self.im2, device))
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)

    def __call__(self, im1: torch.Tensor, im2: torch.Tensor, route: str
                 ) -> Dict[str, Any]:
        with torch.cuda.device(self.device):
            for src, dst in ((im1, self.im1), (im2, self.im2)):
                if route == "staged":
                    staged_copy(src, dst)
                else:
                    dst.copy_(src)
            self.graph.replay()
            out = {key: t.clone() for key, t in self.out.items()
                   if key != "flows"}
            out["flows"] = [(f.clone(), b.clone())
                            for f, b in self.out["flows"]]
        return out


def _outputs(model: Net, im1: torch.Tensor, im2: torch.Tensor,
             shard: Optional[WidthShard] = None, cols=None
             ) -> Dict[str, Any]:
    """The network, the occlusion check and the NHWC outputs on NCHW fp32
    images on the model's device: what ``EntryGraph`` captures."""
    occ = model.conf.occlusion
    with torch.no_grad(), fp32_numerics():
        flow_f, flow_b, flows = model(im1, im2, shard)
        with span("upflow.occlusion"):
            occ_fw, occ_bw = occ_check(
                flow_f, flow_b, occ.alpha_1, occ.alpha_2,
                occ.occ_check_obj_out_all, occ.occ_type, cols=cols)
    with span("upflow.copy_out"):
        return {
            "flow_f_out": nhwc(flow_f),
            "flow_b_out": nhwc(flow_b),
            "occ_fw": nhwc(occ_fw),
            "occ_bw": nhwc(occ_bw),
            "flows": [(nhwc(f), nhwc(b)) for f, b in flows],
        }


def forward(model: Net, im1, im2,
            shard: Optional[WidthShard] = None) -> Dict[str, Any]:
    """Inference forward (``UPFlow_net.forward`` with if_loss=False): flows
    and analytic occlusion masks.

    ``im1``, ``im2``: (B, H, W, 3) NHWC, tensors or arrays; they are moved
    to the model's device.  Returns NHWC ``flow_f_out``, ``flow_b_out``
    (B, H, W, 2), ``occ_fw``, ``occ_bw`` (B, H, W, 1) and ``flows``, the
    per-level ``[(flow_f, flow_b)]`` list finest-first, all fp32 whatever
    the compute dtype, and each a tensor of its own.  Runs under
    ``fp32_numerics``.  With ``shard`` (``parallel/spatial.py::
    WidthShard``) every output is this rank's columns ``shard.cols(w)`` of
    its width ``w`` (``UPFlowNet.forward``).  A ``RAFTNet`` serves the
    same outputs, ``flows`` its final pair and its 1/8 pair, and raises
    on a shard; so does a ``GMFlowNet``.

    On the card the call is served by the model's ``EntryGraph`` for its
    ``graph_key`` where ``eager_reason`` finds none: the key's first call
    runs eagerly, its second captures the graph, later ones replay it, under
    the model's ``GraphCache.lock``.  ``forward.graph_captures``,
    ``.graph_replays`` and ``.eager_calls`` (by reason) count the calls,
    ``.input_copies`` their copies in by ``input_route``.  The caller may
    overwrite its arrays once the call returns."""
    device = next(model.parameters()).device
    im1, im2 = host_tensor(im1), host_tensor(im2)
    route = input_route(device, im1, im2)
    _counts.input_copies[route] += 1
    reason = eager_reason(model, device, shard)
    if reason is None:
        key = graph_key(model, im1.shape, im2.shape, device)
        graphs = model.__dict__.setdefault("_entry_graphs", GraphCache())
        with graphs.lock:
            seen, graph = graphs.take(key)
            if graph is not None:
                _counts.graph_replays += 1
            elif seen:
                graph = EntryGraph(model, im1.shape, im2.shape, device)
                graphs.entries[key] = graph
                _counts.graph_captures += 1
            if seen:
                return graph(im1, im2, route)
        reason = "first_at_key"
    _counts.eager_calls[reason] += 1
    with span("upflow.forward"):
        with span("upflow.copy_in"):
            if route == "staged":
                im1, im2 = (staged_copy(x, torch.empty_like(x, device=device))
                            for x in (im1, im2))
            im1, im2 = as_nchw(im1, device), as_nchw(im2, device)
        cols = None if shard is None else shard.at(im1.shape[3])
        return _outputs(model, im1, im2, shard, cols)


forward.graph_captures = 0
forward.graph_replays = 0
forward.eager_calls = dict.fromkeys(EAGER_REASONS, 0)
forward.input_copies = dict.fromkeys(INPUT_ROUTES, 0)
_counts = forward  # the counters' owner, also where a caller wraps forward
