"""The column algebra of a width-sharded frame.

A frame's width is split over the ranks of a ``parallel/spatial.py::
WidthShard``: rank s of S holds the columns ``[floor(s*W/S),
floor((s+1)*W/S))`` of every map of global width ``W`` (``split``).  The
model's ops take a ``Columns`` beside such a map: the rank's columns of a
map of one width, with the shard's collectives bound to that width
(``window``, ``halo``, ``gather``, ``all_sum``).  ``conv_width`` and
``conv_window`` give a conv's output width and the input window that a
rank's output columns read.  Nothing here talks to a process group
itself: the shard does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

Span = Tuple[int, int]
Request = Callable[[int], Span]


def split(width: int, parts: int) -> List[Span]:
    """The columns ``[floor(s*W/S), floor((s+1)*W/S))`` of each of
    ``parts`` ranks in a map of ``width`` columns."""
    return [(s * width // parts, (s + 1) * width // parts)
            for s in range(parts)]


def conv_width(width: int, kernel: int, stride: int, padding: int,
               dilation: int) -> int:
    """The output width of a conv over ``width`` columns."""
    return (width + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


@dataclasses.dataclass(frozen=True)
class Columns:
    """This rank's columns of a map of ``width`` columns on ``shard`` (a
    ``parallel/spatial.py::WidthShard``): what the model's ops take beside
    a column-sharded map."""

    shard: Any
    width: int

    @property
    def rank(self) -> int:
        return self.shard.rank

    @property
    def lo(self) -> int:
        return split(self.width, self.shard.size)[self.rank][0]

    @property
    def hi(self) -> int:
        return split(self.width, self.shard.size)[self.rank][1]

    def spans_of(self, width: int) -> List[Span]:
        """Every rank's columns of a map of ``width`` columns."""
        return split(width, self.shard.size)

    def to(self, width: int) -> "Columns":
        """The same rank's columns of a map of ``width`` columns."""
        return Columns(self.shard, width)

    def window(self, x: torch.Tensor, request: Request,
               outside: str = "zero") -> torch.Tensor:
        return self.shard.window(x, self.width, request, outside)

    def halo(self, x: torch.Tensor, left: int, right: int,
             outside: str = "zero") -> torch.Tensor:
        return self.shard.halo(x, self.width, left, right, outside)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.gather(x, self.width)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.shard.all_sum(t)


def conv_window(x: torch.Tensor, cols: Columns, kernel: int, stride: int,
                padding: int, dilation: int) -> torch.Tensor:
    """The input columns that this rank's output columns ``[a, b)`` of a
    conv read, ``[a*s - p, (b-1)*s - p + d*(k-1) + 1)``, zero outside the
    frame (the conv's zero padding).  The conv then runs on the window
    with no column padding."""
    spans = cols.spans_of(conv_width(cols.width, kernel, stride, padding,
                                     dilation))

    def request(r: int) -> Span:
        a, b = spans[r]
        return (a * stride - padding,
                (b - 1) * stride - padding + dilation * (kernel - 1) + 1)

    return cols.window(x, request)
