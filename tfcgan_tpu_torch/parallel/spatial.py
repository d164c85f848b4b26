"""The ``spatial`` mesh axis: image rows over a spatial process group, with
halo exchange.

The JAX package shards an image's H over the mesh's ``spatial`` axis
(``tfcgan_tpu.parallel.mesh.image_sharding``) and lets GSPMD insert each
conv's halo exchange; here the ranks of one (data, tensor) coordinate form a
spatial process group and the spatially aware layers carry the exchange.

**The row partition.** A map of global height ``h`` is split over the S
ranks of the group by one rule, the balanced split: rank s holds rows
[ceil(s h / S), ceil((s + 1) h / S)), so the first ranks hold the extra rows
and a rank holds none only where h < S. The local row count alone does not
give ``h`` (128 rows on rank 0 of 2 are a shard of 255 rows or of 256), so
the global height travels beside the activation as a small record,
``Rows(axis, h)``: the spatially aware forwards take the ``Rows`` of their
input as an argument (``rows=``), derive their output's from their geometry,
and a batch's image rows are set for the step by the trainer
(``image_rows`` / ``active_rows``). A skip and the upsampled map it is
concatenated to have the same global height, so they share one partition.

**The halo exchange.** ``row_op`` runs a layer on row shards: for this
rank's output rows it asks the layer which global input rows they read
(``need``), fetches those that other ranks hold (``fetch_rows``), and runs
the layer on that window (``compute``), padded only at the global top and
bottom. ``fetch_rows`` is one autograd function: every rank puts its first
and last rows (as many as any neighbour needs) into one buffer, one
all-gather over the spatial group (gloo on the host, NCCL on cards; the
same call on both) hands each rank its neighbours' strips, and the backward
all-gathers each rank's gradients of the rows it fetched and adds them, each
onto the rows of its owner. Only adjacent shards are read. Where a rank
would get no output rows, or a row it needs lies beyond the adjacent shard,
the layer runs on the whole map on every spatial rank instead: ``gather_spatial``
in, the layer, ``split_rows`` out. ``REPLICATED_LAYERS`` counts those runs;
at 256² and S = 2 the main path has none but the 1-row maps of the pix2pix
G2 (its innermost conv) and of the 128² deformable STN's bottleneck.

**The edges.** The window that ``row_op`` hands a layer is padded at the
map's global top and bottom only, in the layer's own way (``edge``): zero
rows for the zero-padded convs; the reflection (rows 1 .. p mirrored, the
edge row left out) for the ResNet generator's reflection-padded convs
(``models/resnet_gen``), whose mirrored rows the exchange fetches with the
window; or none (``"clip"``): the layer pads by itself, as the transposed
conv, the upsample head and the blur-pool do. ``window_op`` runs a pooling
window on the clipped rows from an input row that is a multiple of its
stride, so that the layer's own padding falls where the whole map's does:
the Encoder's 3 x 3 max-pool over -inf rows and its 8 x 8 mean, and
``ops/resize.avg_pool_2x``, whose mean leaves the padding out of its count.
Each is the one exchange of ``row_op``.

**Layers that read anywhere.** Two layers read rows that no halo bounds,
inside a kernel: the STN's affine warp (theta can put an output row's samples
on any source row; K2's y-pass) and the diffusion U-Net's attention (every
query reads every pixel's key; K4). For them the operand read anywhere is
gathered once over the spatial group (``gather_spatial``: the warp's float32
intermediate after the x-pass, the attention's group-normed map before the k
and v projections) and the kernel computes only this rank's output rows: K2
from its first output row ``o_base``, K4 with this rank's queries against
every key (``sq`` < ``sk``). NeMAR's STNs sample their targets with K3 in the
same way: the targets are gathered once, and the grid is this rank's rows of
the global grid (``ops/gridsample.grid_sample_dense(rows=)``). The kernel's gradient of that operand is then
whole on every rank, and the gather's backward (a reduce-scatter) sums it
back onto each owner's rows. The STN's localizer, a ViT over the whole
(A, condition) pair, runs whole on every rank on the pair gathered once
(``models/stn.AffineSTN.theta``), and so gives every rank the same theta.
The other small heads that flatten a whole map into a Dense layer run the
same way, on the small map gathered once: NeMAR's conv-affine localizer
(an 8 x 8 map at 256²) and the ThermalGAN Encoder's ``fc_mu`` and
``fc_logvar`` (2 x 2).

**The gradient rule (option A).** Each spatial rank back-propagates its own
share of the loss, and every parameter gradient is summed over the spatial
group. So:

- a mean over pixels is this rank's sum over its rows divided by the global
  count (``share_mean``): the shares sum to the mean;
- a statistic that a layer uses as a whole (instance norm's mean and
  variance) is the group's sum (``spatial_sum``, whose backward sums the
  ranks' upstream gradients);
- a term computed on whole images on every rank (the FFT, triplet,
  temperature and region losses after ``gather_spatial``) is counted once: each
  rank takes 1 / S of it (``replicated_share``);
- ``gather_spatial``' backward is a reduce-scatter (the ranks' gradients of the
  whole map summed, each rank keeping its rows); ``split_rows``' backward
  puts the rank's gradient into its rows and zeros elsewhere, with no
  communication;
- the trainer sums each replicated parameter's gradient over the spatial
  group (and averages it over the data group), and its metrics, being
  shares, are summed over the spatial group too.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from tfcgan_tpu_torch.parallel.tensor import _AllReduceSum

# layers run on the whole map on every spatial rank (see the module docstring)
REPLICATED_LAYERS = 0


@dataclasses.dataclass(frozen=True)
class SpatialAxis:
    """This rank's spatial process group, its rank in it and the group's size."""

    group: object
    rank: int
    size: int


def row_bounds(h: int, rank: int, size: int) -> tuple[int, int]:
    """Rank ``rank``'s rows [lo, hi) of ``h`` over ``size`` ranks."""
    return (rank * h + size - 1) // size, ((rank + 1) * h + size - 1) // size


@dataclasses.dataclass(frozen=True)
class Rows:
    """A row shard: this rank's rows of a map of global height ``h``."""

    axis: SpatialAxis
    h: int

    def span(self, rank: int | None = None) -> tuple[int, int]:
        return row_bounds(self.h, self.axis.rank if rank is None else rank, self.axis.size)

    @property
    def lo(self) -> int:
        return self.span()[0]

    @property
    def hi(self) -> int:
        return self.span()[1]

    @property
    def n(self) -> int:
        lo, hi = self.span()
        return hi - lo

    def of(self, h: int) -> "Rows":
        """The record of another map of global height ``h`` on the same axis."""
        return Rows(self.axis, h)

    def cut(self, x, dim: int = 1):
        """This rank's rows of the whole map ``x`` (a tensor or an array,
        rows on ``dim``): a view."""
        lo, hi = self.span()
        return x[(slice(None),) * dim + (slice(lo, hi),)]


_IMAGE_ROWS: Rows | None = None


@contextlib.contextmanager
def image_rows(rows: Rows | None):
    """Make the row record of the step's images visible inside the block."""
    global _IMAGE_ROWS
    prev, _IMAGE_ROWS = _IMAGE_ROWS, rows
    try:
        yield
    finally:
        _IMAGE_ROWS = prev


def active_rows() -> Rows | None:
    """The record of the running step's image rows, or None off a spatial mesh."""
    return _IMAGE_ROWS


# ----------------------------------------------------------- gather and split
def _bits(x: torch.Tensor) -> torch.Tensor:
    """A 2-byte ``x`` as a byte view of the same bits, for a copy-only
    collective (gloo takes neither int16 nor, in every version, bfloat16)."""
    return x.view(torch.uint8) if x.element_size() == 2 else x


def _all_gather(x: torch.Tensor, axis: SpatialAxis) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather([_bits(p) for p in parts], _bits(x), group=axis.group)
    return parts


def _all_reduce_sum(x: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """The group's sum, taken in float32 for a 2-byte type."""
    y = x.float() if x.element_size() == 2 else x.clone()
    dist.all_reduce(y, group=axis.group)
    return y.to(x.dtype)


def _pad_rows(x: torch.Tensor, n: int, front: bool = False) -> torch.Tensor:
    """``x`` (rows on dim 1) padded with zero rows to ``n`` rows."""
    if x.shape[1] == n:
        return x
    zeros = x.new_zeros((x.shape[0], n - x.shape[1], *x.shape[2:]))
    return torch.cat([zeros, x] if front else [x, zeros], dim=1)


def _gather_whole(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    most = max(hi - lo for lo, hi in (rows.span(s) for s in range(rows.axis.size)))
    parts = _all_gather(_pad_rows(x, most), rows.axis)
    return torch.cat([p[:, :hi - lo] for p, (lo, hi)
                      in zip(parts, (rows.span(s) for s in range(rows.axis.size)))], dim=1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return _gather_whole(x, rows)

    @staticmethod
    def backward(ctx, g):
        return ctx.rows.cut(_all_reduce_sum(g, ctx.rows.axis)), None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return rows.cut(x).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        rows = ctx.rows
        return _pad_rows(_pad_rows(g, rows.hi, front=True), rows.h), None


def gather_spatial(x: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """The whole map (N, H, ...) from its row shards ``x`` of record
    ``rows``, before an op that needs the whole H (the JAX
    ``gather_spatial``); ``x`` itself without ``rows``. Backward: the group's
    summed gradient, this rank's rows (a reduce-scatter)."""
    if rows is None or rows.axis.size == 1:
        return x
    return _GatherRows.apply(x, rows)


def split_rows(x: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """This rank's rows of the whole map ``x`` computed on every rank;
    backward: the rank's gradient in its rows, zeros elsewhere."""
    if rows is None or rows.axis.size == 1:
        return x
    return _SplitRows.apply(x, rows)


# ------------------------------------------------------------ reductions
def spatial_sum(x: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """The spatial group's sum of ``x`` (float32); backward: the sum of the
    ranks' upstream gradients. ``x`` itself without ``rows``."""
    if rows is None or rows.axis.size == 1:
        return x
    return _AllReduceSum.apply(x, rows.axis.group)


def share_mean(x: torch.Tensor, rows: Rows | None, dims=None) -> torch.Tensor:
    """This rank's share of the mean of a row-sharded ``x`` (rows on dim 1)
    over ``dims`` (default: every element): its sum over its rows divided
    by the global count. The group's shares sum to the mean."""
    if rows is None:
        return x.mean() if dims is None else x.mean(dim=dims)
    dims = tuple(range(x.dim())) if dims is None else dims
    count = rows.h
    for d in dims:
        if d % x.dim() != 1:
            count *= x.shape[d]
    return x.sum(dim=dims) / count


def replicated_share(x: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """This rank's share of a term that every spatial rank computes whole."""
    if rows is None or rows.axis.size == 1:
        return x
    return x / rows.axis.size


# ------------------------------------------------------------- halo exchange
@dataclasses.dataclass(frozen=True)
class _Plan:
    """Rows fetched by each rank: ``top[s]`` rows from rank s - 1's bottom,
    ``bottom[s]`` from rank s + 1's top; each rank contributes its first
    ``kt`` and last ``kb`` rows."""

    top: tuple[int, ...]
    bottom: tuple[int, ...]
    kt: int
    kb: int


def _plan(rows: Rows, spans: list[tuple[int, int]]) -> _Plan | None:
    """The exchange that gives each rank s the clipped input rows
    ``spans[s]``, or None where one lies beyond an adjacent shard."""
    size = rows.axis.size
    top, bottom = [], []
    for s, (a, b) in enumerate(spans):
        lo, hi = rows.span(s)
        if a < lo and (s == 0 or a < rows.span(s - 1)[0]):
            return None
        if b > hi and (s == size - 1 or b > rows.span(s + 1)[1]):
            return None
        top.append(max(0, lo - a))
        bottom.append(max(0, b - hi))
    return _Plan(tuple(top), tuple(bottom), max(bottom), max(top))


class _FetchRows(torch.autograd.Function):
    """Global rows [a, b) of the map from this rank's shard and its
    neighbours', with zero rows where they leave the map; backward: the
    fetched rows' gradients added to their owners' (an all-gather of the
    halo gradients)."""

    @staticmethod
    def forward(ctx, x, rows, plan, a, b):
        s, (lo, hi), h = rows.axis.rank, rows.span(), rows.h
        ca, cb = max(a, 0), min(b, h)
        ctx.rows, ctx.plan, ctx.a, ctx.b = rows, plan, a, b
        k = plan.kt + plan.kb
        strips = None
        if k:  # each rank's first kt and last kb rows
            strip = torch.cat([_pad_rows(x[:, :plan.kt], plan.kt),
                               _pad_rows(x[:, max(0, x.shape[1] - plan.kb):], plan.kb,
                                         front=True)], dim=1)
            strips = _all_gather(strip, rows.axis)
        zeros = x.new_zeros((x.shape[0], 1, *x.shape[2:]))
        pieces = [zeros.expand(-1, ca - a, *x.shape[2:])] if ca > a else []
        if ca < lo:  # rank s - 1's last kb rows are rows [lo - kb, lo)
            pieces.append(strips[s - 1][:, k - (lo - ca):k - (lo - min(cb, lo))])
        if min(cb, hi) > max(ca, lo):
            pieces.append(x[:, max(ca, lo) - lo:min(cb, hi) - lo])
        if cb > hi:  # rank s + 1's first kt rows are rows [hi, hi + kt)
            pieces.append(strips[s + 1][:, max(ca, hi) - hi:cb - hi])
        if b > cb:
            pieces.append(zeros.expand(-1, b - cb, *x.shape[2:]))
        return torch.cat(pieces, dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, plan, a, b = ctx.rows, ctx.plan, ctx.a, ctx.b
        s, (lo, hi), h = rows.axis.rank, rows.span(), rows.h
        ca, cb = max(a, 0), min(b, h)
        n = hi - lo
        dx = g.new_zeros((g.shape[0], n, *g.shape[2:]))
        own_lo, own_hi = max(ca, lo), min(cb, hi)
        if own_hi > own_lo:
            dx[:, own_lo - lo:own_hi - lo] = g[:, own_lo - a:own_hi - a]
        if plan.kt + plan.kb:
            # my bottom halo's gradient goes to rank s + 1's first kt rows,
            # my top halo's to rank s - 1's last kb rows
            mine = g.new_zeros((g.shape[0], plan.kt + plan.kb, *g.shape[2:]))
            if cb > hi:
                mine[:, max(ca, hi) - hi:cb - hi] = g[:, max(ca, hi) - a:cb - a]
            if ca < lo:
                k = plan.kt + plan.kb
                mine[:, k - (lo - ca):k - (lo - min(cb, lo))] = g[:, ca - a:min(cb, lo) - a]
            theirs = _all_gather(mine, rows.axis)
            if s + 1 < rows.axis.size and plan.kb:  # rank s + 1's top halo: my last rows
                k = min(n, plan.kb)
                dx[:, n - k:] += theirs[s + 1][:, plan.kt + plan.kb - k:]
            if s > 0 and plan.kt:  # rank s - 1's bottom halo: my first rows
                k = min(n, plan.kt)
                dx[:, :k] += theirs[s - 1][:, :k]
        return dx, None, None, None, None


def fetch_rows(x: torch.Tensor, rows: Rows, a: int, b: int, plan: _Plan) -> torch.Tensor:
    """Global rows [a, b) of the map, zero outside [0, rows.h); ``plan``
    from ``_plan`` for every rank's clipped rows."""
    return _FetchRows.apply(x, rows, plan, a, b)


def _pad_edges(x: torch.Tensor, top: int, bottom: int, edge: str) -> torch.Tensor:
    """``x``, the map's rows from its global top (``top`` > 0) or down to its
    global bottom (``bottom`` > 0), padded there: zero rows (``"zero"``) or
    the reflection that leaves the edge row out (``"reflect"``: the rows 1
    .. top below the top, and the mirror image above the bottom)."""
    if not top and not bottom:
        return x
    if edge == "reflect":
        parts = [x[:, 1:top + 1].flip(1)] if top else []
        parts.append(x)
        if bottom:
            parts.append(x[:, -bottom - 1:-1].flip(1))
        return torch.cat(parts, dim=1)
    return torch.cat([x.new_zeros((x.shape[0], top, *x.shape[2:])), x,
                      x.new_zeros((x.shape[0], bottom, *x.shape[2:]))], dim=1)


def row_op(x: torch.Tensor, rows: Rows, h_out: int, need, compute, edge: str = "zero"
           ) -> torch.Tensor:
    """A layer on row shards: this rank's rows of its output, of global
    height ``h_out``. ``need(o_lo, o_hi)`` gives the global input rows [a, b)
    that the output rows [o_lo, o_hi) read, unclipped; ``compute(xw, a, b,
    o_lo, o_hi)`` computes those output rows from ``xw``: the input rows [a,
    b), padded where they leave the map with zero rows (``edge="zero"``) or
    by reflection (``"reflect"``: the rows read there are the mirror images
    of rows 1 .. of the map, which the window then holds), or the clipped
    rows [max(a, 0), min(b, h)) (``"clip"``: the layer pads by itself, as a
    max-pool pads with -inf and a mean leaves the padding out of its count;
    ``window_op``). One exchange in every case. Where the halo exchange
    cannot serve every rank, the layer runs on the whole map on every rank
    (``REPLICATED_LAYERS``)."""
    out = rows.of(h_out)
    size, h = rows.axis.size, rows.h

    def fetched(a, b):  # the rows the exchange must deliver for [a, b)
        if edge == "reflect":  # with the mirror images' sources, inside the map
            return max(0, min(a, 2 * h - 1 - b)), min(h, max(b, 1 - a))
        return max(0, a), min(h, b)

    spans = [out.span(s) for s in range(size)]
    needs = [need(o_lo, o_hi) for o_lo, o_hi in spans]
    plan = None
    if all(o_hi > o_lo for o_lo, o_hi in spans):
        plan = _plan(rows, [fetched(a, b) for a, b in needs])

    def window(xw, a, b, fa):  # xw: the fetched rows from fa -> the layer's window
        if edge == "clip":
            return xw, fa, fa + xw.shape[1]
        top = max(0, -a)
        return _pad_edges(xw, top, max(0, b - h), edge)[:, a - fa + top:b - fa + top], a, b

    if plan is None:
        a, b = need(0, h_out)
        fa, fb = fetched(a, b)
        return on_whole_map(x, rows, out,
                            lambda whole: compute(*window(whole[:, fa:fb], a, b, fa), 0, h_out))
    a, b = needs[rows.axis.rank]
    fa, fb = fetched(a, b)
    xw, a, b = window(fetch_rows(x, rows, fa, fb, plan), a, b, fa)
    return compute(xw, a, b, *spans[rows.axis.rank])


def on_whole_map(x: torch.Tensor, rows: Rows, out: Rows, fn) -> torch.Tensor:
    """``fn`` on the whole map on every rank, from this rank's rows of the
    input (record ``rows``) to its rows of the output (record ``out``): a
    layer whose reads the halo exchange cannot serve; counted in
    ``REPLICATED_LAYERS``."""
    global REPLICATED_LAYERS
    REPLICATED_LAYERS += 1
    return split_rows(fn(gather_spatial(x, rows)), out)


def window_op(x: torch.Tensor, rows: Rows | None, k: int, stride: int, pad: int, op
              ) -> torch.Tensor:
    """A pooling window (``k`` rows, ``stride``, ``pad`` rows on each side)
    on row shards (``op(x)`` itself without ``rows``), where ``op`` is the
    layer on a whole map with its own padding: a max-pool's -inf rows, a
    mean's rows left out of its count (``count_include_pad=False``). On row
    shards ``op`` runs on this rank's window from an
    input row that is a multiple of ``stride``, so that its windows fall
    where the whole map's do; the first rows of a window that does not start
    at the map's top read ``op``'s padding instead of real rows, and so do
    the last of one that does not end at its bottom, and those output rows
    are dropped: the rows kept read no padding but the map's own."""
    if rows is None or rows.axis.size == 1:
        return op(x)
    h_out = (rows.h + 2 * pad - k) // stride + 1
    back = -(-pad // stride)  # output rows whose windows the start's padding touches

    def need(lo, hi):
        return stride * max(0, lo - back), stride * (hi - 1) - pad + k

    def compute(xw, a, b, lo, hi):
        first = a // stride  # the output row of op's first window
        return op(xw)[:, lo - first:hi - first]

    return row_op(x, rows, h_out, need, compute, edge="clip")
