"""Width sharding: the 'spatial' mesh axis of the eval step, by hand.

The JAX package shards the frame's width over its mesh's 'spatial' axis
and lets GSPMD insert the halo exchanges and the gathers around every op
that reads across columns (``upflow_pytorch_tpu/parallel/step.py::
make_sharded_eval_step``).  The port writes them out: each rank of a
``WidthShard`` holds the columns ``[floor(s*W/S), floor((s+1)*W/S))`` of
every map of global width ``W`` (``cols``; the pyramid's widths are
ceil-halved, 1242 -> 621 -> ... -> 20, so the splits are uneven at most
levels), and the model's ops ask for the columns they read:

- ``window``: global columns ``[lo, hi)`` of a column-sharded map, zero
  outside the frame or clipped to it; a halo of a few columns around a
  conv or a correlation, or a window that spans several ranks where a
  dilated conv's halo is wider than a shard;
- ``gather``: the whole map, for the warps, whose taps land at
  data-dependent columns;
- ``all_sum``: the moments of the normalisation, over every rank's own
  columns.

The column algebra (``split``, ``Columns``, ``conv_window``) lives in
``ops/columns.py``, so that the model's ops need nothing of this module.

``window`` is one collective.  Every rank works out every rank's request
from the global shapes (a request is a function of the rank), writes the
part of its own columns that each other rank needs into a zeroed buffer,
and the buffer is all-reduced; each rank then reads its part.  The sum
runs over an integer view of the buffer (int32 words: one fp32 value, or
two bf16 values), so adding the other ranks' zeros copies each bit
pattern exactly, -0.0 included, and the collective takes one path on
NCCL and on gloo: gloo has no CUDA ``all_gather``, and NCCL refuses two
ranks on one card, which is how the card's host with one GPU rehearses
two ranks.  Nothing is sent where no rank needs another's columns (a
1x1 conv).  ``bytes_reduced`` and ``collectives`` count, in Python, what
this rank has all-reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from upflow_pytorch_tpu_torch.ops.columns import Columns, Request, Span, split

_WORD = {4: torch.int32, 2: torch.int32, 8: torch.int64}


def _outside(req: Span, own: Span, width: int) -> List[Span]:
    """The columns of ``req`` inside the frame that a rank owning ``own``
    must get from the others: at most one run left and one right of
    ``own``."""
    a, b = max(req[0], 0), min(req[1], width)
    lo, hi = own
    parts = []
    if a < min(b, lo):
        parts.append((a, min(b, lo)))
    if max(a, hi) < b:
        parts.append((max(a, hi), b))
    return parts


@dataclasses.dataclass(eq=False)
class WidthShard:
    """The ranks of ``group`` that split the width of one data row:
    ``rank`` of ``size``.  ``bytes_reduced`` and ``collectives`` count what
    this rank has all-reduced since they were last set to 0."""

    group: Any
    rank: int
    size: int
    bytes_reduced: int = 0
    collectives: int = 0

    def spans(self, width: int) -> List[Span]:
        """Every rank's columns of a map of ``width`` columns."""
        return split(width, self.size)

    def cols(self, width: int) -> Span:
        """This rank's columns ``(lo, hi)`` of a map of ``width``
        columns."""
        return self.spans(width)[self.rank]

    def check(self, widths: Dict[str, int]) -> None:
        """Raises ``ValueError`` naming the first of the maps ``{name:
        width}`` that leaves a rank no column."""
        for name, width in widths.items():
            if width < self.size:
                raise ValueError(
                    "%s is %d columns wide: split over %d ranks it leaves a "
                    "rank no column" % (name, width, self.size))

    def at(self, width: int) -> "Columns":
        """This rank's columns of a map of ``width`` columns."""
        return Columns(self, width)

    def _all_reduce_words(self, flat: torch.Tensor) -> None:
        word = _WORD.get(flat.element_size())
        if word is None:
            raise TypeError("no integer view for %s" % flat.dtype)
        dist.all_reduce(flat.view(word), group=self.group)
        self.bytes_reduced += flat.numel() * flat.element_size()
        self.collectives += 1

    def window(self, x: torch.Tensor, width: int, request: Request,
               outside: str = "zero") -> torch.Tensor:
        """Global columns ``request(self.rank) = [lo, hi)`` of a map of
        ``width`` columns whose columns ``cols(width)`` this rank holds in
        ``x`` (..., cols).  ``request(r)`` must give every rank's request,
        alike on every rank.  Columns outside the frame are zeros
        (``outside="zero"``), or the window is clipped to the frame
        (``"clip"``: columns ``[max(lo, 0), min(hi, width))``).  One
        all-reduce, where any rank needs another's columns."""
        if outside not in ("zero", "clip"):
            raise ValueError("outside must be 'zero' or 'clip', got %r"
                             % (outside,))
        spans = self.spans(width)
        lo, hi = spans[self.rank]
        if x.shape[-1] != hi - lo:
            raise ValueError("rank %d holds columns [%d, %d) of %d, but the "
                             "map has %d" % (self.rank, lo, hi, width,
                                             x.shape[-1]))
        reqs = [tuple(request(r)) for r in range(self.size)]
        needs = [_outside(req, spans[r], width) for r, req in enumerate(reqs)]
        total = sum(e - s for parts in needs for s, e in parts)
        lead = tuple(x.shape[:-1])
        got = []
        if total:
            n = total
            for d in lead:
                n *= d
            flat = x.new_zeros(n + (n % 2 if x.element_size() == 2 else 0))
            buf = flat[:n].view(lead + (total,))
            off = 0
            for r, parts in enumerate(needs):
                for s, e in parts:
                    cs, ce = max(s, lo), min(e, hi)
                    if cs < ce:
                        buf[..., off + cs - s:off + ce - s] = \
                            x[..., cs - lo:ce - lo]
                    if r == self.rank:
                        got.append((s, e, off))
                    off += e - s
            self._all_reduce_words(flat)
        a, b = reqs[self.rank]
        if outside == "clip":
            a, b = max(a, 0), min(b, width)
        if (a, b) == (lo, hi):
            return x
        out = x.new_zeros(lead + (b - a,))
        s, e = max(a, lo), min(b, hi)
        if s < e:
            out[..., s - a:e - a] = x[..., s - lo:e - lo]
        for s, e, off in got:
            out[..., s - a:e - a] = buf[..., off:off + e - s]
        return out

    def halo(self, x: torch.Tensor, width: int, left: int, right: int,
             outside: str = "zero") -> torch.Tensor:
        """``window`` of every rank's own columns widened by ``left`` and
        ``right``."""
        spans = self.spans(width)
        return self.window(x, width,
                           lambda r: (spans[r][0] - left, spans[r][1] + right),
                           outside)

    def gather(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """The whole map of ``width`` columns on every rank."""
        return self.window(x, width, lambda r: (0, width))

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (a new tensor)."""
        t = t.contiguous().clone()
        dist.all_reduce(t, group=self.group)
        self.bytes_reduced += t.numel() * t.element_size()
        self.collectives += 1
        return t
