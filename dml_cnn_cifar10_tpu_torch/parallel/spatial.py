"""Spatial partitioning of a conv model over the mesh's ``seq`` ranks.

Port of the JAX package's spatial split (``parallel/mesh.py:56-74``,
``parallel/step.py:525-529``; ``models/registry.py`` marks the CNN
``spatial``). There the image H dim is sharded over ``seq`` and GSPMD puts
in the halo exchanges that the convolutions and pools need; here they are
explicit. Seq rank ``s`` of a data row holds rows ``[s·H/S, (s+1)·H/S)``
of its data rank's images (:meth:`Split.even`), and each layer's rows are
a :class:`Split`: every rank's first row and row count, the same on every
rank.

- :func:`conv2d` (stride 1, TF "SAME"): the rows above and below that the
  kernel reaches come from the neighbouring seq ranks, zeros past the
  image's edges (the SAME padding); the rank's output rows are its input
  rows.
- :func:`max_pool` (TF "SAME", ``-inf`` padding): output row ``i`` belongs
  to the rank that holds its window's first row, and each rank takes the
  rows its windows reach from the rank below (``-inf`` past the bottom
  edge). Where the stride leaves a rank's rows unaligned (24 px over 4
  ranks: 3 rows a rank before the second pool) the ranks hold different
  counts of output rows, and a rank may need two rows from below; both
  are fine as long as each rank's rows come from its direct neighbours.
- :func:`gather`: the rows of every rank, whole, on every rank (before the
  flatten: the FCs run on the whole map).

Each exchange is an autograd Function whose backward returns a halo's
gradient to the rank it came from (:meth:`Mesh.start_hop` over ``seq``,
both ways at once). The gather's backward is its transpose, the sum of
the cotangents over the seq ranks, of which each keeps its rows (JAX's
``psum_scatter``). Every seq rank computes the same loss from the same
gathered map, so that sum is ``S`` times one rank's: every leaf's gradient
arrives ``S`` times over — the convolutions' as ``S`` times their rows'
share, summed over the seq ranks by the step's all-reduce; the FCs' as the
whole gradient on each of the ``S`` ranks — and the step's ``1 /
replicas`` share (``replicas`` counts the seq ranks) makes it the mean,
as the ViT's sequence split does (``models/vit.py``, the pooled sum).
The plain version is the unsplit layer on the whole image
(``ops/layers.py``), which the tests hold every exchange against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF "SAME" padding (before, after) along one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass(frozen=True)
class Split:
    """The rows ``[starts[s], starts[s] + counts[s])`` of an ``h``-row map
    that seq rank ``s`` holds."""

    h: int
    starts: Tuple[int, ...]
    counts: Tuple[int, ...]

    @classmethod
    def even(cls, h: int, n: int) -> "Split":
        if h % n:
            raise ValueError(f"image height {h} does not split over "
                             f"seq_axis={n}")
        return cls(h, tuple(s * (h // n) for s in range(n)),
                   (h // n,) * n)

    def rows(self, s: int) -> slice:
        return slice(self.starts[s], self.starts[s] + self.counts[s])

    def pooled(self, window: int = 3, stride: int = 2) -> "Split":
        """The output rows of a SAME ``window``/``stride`` pool: row ``i``
        on the rank that holds input row ``stride·i − pad`` (the window's
        first row; row 0's is in the padding)."""
        before, _ = _same_pads(self.h, window, stride)
        ho = -(-self.h // stride)
        starts = [0] + [-(-(a + before) // stride) for a in self.starts[1:]]
        counts = [b - a for a, b in zip(starts, starts[1:] + [ho])]
        if min(counts) < 1:
            raise ValueError(
                f"a {window}x{window}/{stride} pool over rows {self} leaves "
                f"a seq rank no output row: too many seq ranks for "
                f"{self.h} rows")
        return Split(ho, tuple(starts), tuple(counts))


def _needs_conv(split: Split, window: int) -> List[Tuple[int, int]]:
    before, after = _same_pads(split.h, window, 1)
    return [(a - before, a + n + after)
            for a, n in zip(split.starts, split.counts)]


def _needs_pool(split: Split, window: int, stride: int
                ) -> List[Tuple[int, int]]:
    before, _ = _same_pads(split.h, window, stride)
    out = split.pooled(window, stride)
    return [(stride * a - before, stride * (a + n - 1) - before + window)
            for a, n in zip(out.starts, out.counts)]


class _Halo:
    """Which rows each rank sends and receives when every rank ``s``
    needs rows ``needs[s] = (lo, hi)`` of a :class:`Split` (rows past the
    map's edges are padding): from its direct neighbours only."""

    def __init__(self, split: Split, needs: Sequence[Tuple[int, int]]):
        n = len(split.counts)
        self.split = split
        self.above, self.below, self.pad, self.keep = [], [], [], []
        for s, (lo, hi) in enumerate(needs):
            a, c = split.starts[s], split.counts[s]
            above = max(0, a - max(lo, 0))
            below = max(0, min(hi, split.h) - (a + c))
            if (above and (s == 0 or split.counts[s - 1] < above)) or (
                    below and (s == n - 1 or split.counts[s + 1] < below)):
                raise ValueError(
                    f"seq rank {s} needs rows [{lo}, {hi}) of {split}: more "
                    f"than its neighbours hold (too many seq ranks for "
                    f"{split.h} rows)")
            self.above.append(above)
            self.below.append(below)
            self.pad.append((max(0, -lo), max(0, hi - split.h)))
            self.keep.append(slice(max(lo, a) - a, min(hi, a + c) - a))


def check_rows(split: Split, kernel: int, window: int, stride: int
               ) -> None:
    """Raise ``ValueError`` unless a ``kernel``-tall SAME convolution and
    a ``window``/``stride`` SAME pool over ``split`` take every halo row
    from a direct neighbour (checked before any step)."""
    _Halo(split, _needs_conv(split, kernel))
    _Halo(split, _needs_pool(split, window, stride))


class _Exchange(torch.autograd.Function):
    """``x`` (this rank's rows, NCHW) extended by the rows of ``halo``
    from its neighbours and ``fill`` padding; the backward returns each
    received row's gradient to its sender."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, halo: _Halo, fill: float):
        s = mesh.seq_rank
        ctx.mesh, ctx.halo, ctx.shape = mesh, halo, x.shape
        up = halo.below[s - 1] if s > 0 else 0
        down = halo.above[s + 1] if s + 1 < mesh.seq else 0
        n = x.shape[2]
        got_above, got_below = mesh.start_hop(
            "seq", to_next=x[:, :, n - down:] if down else None,
            to_prev=x[:, :, :up] if up else None,
            from_prev=_rows_like(x, halo.above[s]),
            from_next=_rows_like(x, halo.below[s])).wait()
        pad_a, pad_b = halo.pad[s]
        parts = [_fill_rows(x, pad_a, fill), got_above, x[:, :, halo.keep[s]],
                 got_below, _fill_rows(x, pad_b, fill)]
        return torch.cat([p for p in parts if p is not None], dim=2)

    @staticmethod
    def backward(ctx, g):
        mesh, halo = ctx.mesh, ctx.halo
        s = mesh.seq_rank
        pad_a, pad_b = halo.pad[s]
        above, below = halo.above[s], halo.below[s]
        keep = halo.keep[s]
        own = keep.stop - keep.start
        g = g.contiguous()
        g_above = g[:, :, pad_a:pad_a + above]
        g_own = g[:, :, pad_a + above:pad_a + above + own]
        g_below = g[:, :, pad_a + above + own:pad_a + above + own + below]
        up = halo.below[s - 1] if s > 0 else 0
        down = halo.above[s + 1] if s + 1 < mesh.seq else 0
        dx = g.new_zeros(ctx.shape)
        dx[:, :, keep] = g_own
        # What this rank sent up (its first rows) and down (its last)
        # comes back as the neighbours' gradients of those rows.
        back_top, back_bottom = mesh.start_hop(
            "seq", to_next=g_below if below else None,
            to_prev=g_above if above else None,
            from_prev=_rows_like(dx, up), from_next=_rows_like(dx, down)
        ).wait()
        n = ctx.shape[2]
        if back_top is not None:
            dx[:, :, :up] += back_top
        if back_bottom is not None:
            dx[:, :, n - down:] += back_bottom
        return dx, None, None, None


def _rows_like(x: torch.Tensor, k: int) -> Optional[torch.Tensor]:
    """A buffer template of ``k`` rows of ``x`` (None for none)."""
    if not k:
        return None
    return x.new_empty((x.shape[0], x.shape[1], k, x.shape[3]))


def _fill_rows(x: torch.Tensor, k: int, fill: float
               ) -> Optional[torch.Tensor]:
    if not k:
        return None
    return x.new_full((x.shape[0], x.shape[1], k, x.shape[3]), fill)


def _check(x: torch.Tensor, mesh: Mesh, split: Split) -> None:
    if x.shape[2] != split.counts[mesh.seq_rank]:
        raise ValueError(f"seq rank {mesh.seq_rank} holds {x.shape[2]} "
                         f"rows; its split {split} gives it "
                         f"{split.counts[mesh.seq_rank]}")


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], mesh: Mesh, split: Split
           ) -> torch.Tensor:
    """NCHW stride-1 TF "SAME" convolution (OIHW kernel) of this rank's
    rows of a map split as ``split``: the same rows of the output."""
    _check(x, mesh, split)
    kh, kw = weight.shape[2], weight.shape[3]
    ext = _Exchange.apply(x, mesh, _Halo(split, _needs_conv(split, kh)),
                          0.0)
    pw = _same_pads(x.shape[3], kw, 1)
    return F.conv2d(F.pad(ext, (pw[0], pw[1], 0, 0)), weight, bias)


def max_pool(x: torch.Tensor, mesh: Mesh, split: Split, window: int = 3,
             stride: int = 2) -> torch.Tensor:
    """NCHW TF "SAME" max pool (``-inf`` padding) of this rank's rows of
    a map split as ``split``: this rank's rows of ``split.pooled(window,
    stride)``."""
    _check(x, mesh, split)
    ext = _Exchange.apply(
        x, mesh, _Halo(split, _needs_pool(split, window, stride)),
        float("-inf"))
    pw = _same_pads(x.shape[3], window, stride)
    return F.max_pool2d(F.pad(ext, (pw[0], pw[1], 0, 0),
                              value=float("-inf")), window, stride)


class _Gather(torch.autograd.Function):
    """Every rank's rows, whole; backward the cotangent summed over the
    seq ranks, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, split: Split):
        ctx.mesh, ctx.split = mesh, split
        kmax = max(split.counts)
        piece = F.pad(x, (0, 0, 0, kmax - x.shape[2])).contiguous()
        flat = piece.new_empty((mesh.seq * piece.numel(),))
        mesh.all_gather_(flat, piece.reshape(-1), "seq")
        parts = flat.view(mesh.seq, *piece.shape)
        return torch.cat([parts[s, :, :, :split.counts[s]]
                          for s in range(mesh.seq)], dim=2)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.contiguous().clone(), "seq")
        return g[:, :, ctx.split.rows(ctx.mesh.seq_rank)], None, None


def gather(x: torch.Tensor, mesh: Mesh, split: Split) -> torch.Tensor:
    """The whole map on every seq rank from each rank's rows."""
    _check(x, mesh, split)
    return _Gather.apply(x, mesh, split)


def own_rows(images: torch.Tensor, mesh: Mesh, split: Split
             ) -> torch.Tensor:
    """This seq rank's rows of NHWC ``images`` (a view)."""
    return images[:, split.rows(mesh.seq_rank)]

