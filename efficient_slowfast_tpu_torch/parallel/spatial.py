"""Spatial model parallelism: ``TPU.SPATIAL_SHARD`` (the port's
counterpart of ``parallel/mesh.py``'s space axis, ``frames_sharding`` and
``constrain_spatial``).

A space group is S consecutive ranks (``parallel/distributed.py``) that
hold the same clips. Each keeps one band of every frame's rows: rank i of
the group the rows [i·H/S, (i+1)·H/S) of an activation of height H. The
JAX package states the layout and GSPMD inserts the exchanges; here each
op that spans the height does its own, so the program computes what one
process computes:

- ``constrain`` splits the preprocess output (the ``CROP_SIZE`` grid);
  raw canvases are never split. A height that S does not divide stays
  whole on every rank (JAX's batch-only fallback, ``mesh.py:254-263``).
- ``window`` serves every conv and pool whose kernel, stride or padding
  spans H (``ops/conv.py``, ``ops/pool.py``, ``engine/inference.py``): the
  halo rows of the neighbours (``halo``; the zero or -inf padding at the
  frame's edges), or, where the op's output rows would not fall as whole
  bands on the ranks, the whole height (``gather_height``), after which
  that stage runs whole on every rank.
- ``mean`` reduces over the height across the group (ECA, the efficient
  heads' pools); the classification and RoI heads take the whole height
  (``gather_height``); attention gathers its keys and values
  (``gather_tokens``) and keeps its own queries.
- BN needs nothing here: ``ops/norm.py`` sums counts and moments over
  every rank, a band's or a whole height's (a whole height counted S
  times moves neither the mean nor the variance).

A split activation is an ``HSplit``: a tensor subclass that every torch op
passes on. It refuses the convs, pools and height reductions that would
treat its band as the whole frame, so an op of the model that this module
does not serve raises instead of running unsplit.

Gradients. Every exchange's backward is its forward's adjoint: the halo
gradients go back to the rows' owners and are added, a gather's gradient
is summed over the group and each rank keeps its band, a sum's is summed.
Each rank's loss is a term of the group's, so a parameter's gradient,
summed over the S ranks, is S times the one process's, for the
parameters used before the first exchange (each rank's part) and after
it (whole on each rank) alike; DDP's mean over the D·S ranks then gives
the data-parallel mean.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import distributed

# a split activation refuses these (its height is a band, not the frame)
_WINDOWED = frozenset({
    "conv1d", "conv2d", "conv3d", "conv_transpose3d", "_max_pool3d",
    "max_pool3d", "max_pool3d_with_indices", "avg_pool3d",
    "adaptive_avg_pool3d", "adaptive_max_pool3d", "interpolate",
    "roi_align"})
_REDUCTIONS = frozenset({
    "mean", "sum", "amax", "amin", "max", "min", "var", "std", "var_mean",
    "std_mean", "norm", "logsumexp", "nansum", "nanmean", "prod"})


def _reduces_height(args, kwargs) -> bool:
    """Whether a reduction of a 5-D tensor takes its axis 2 or 3 (H of
    NCDHW, or of its (B, T, H, W, C) view), or every axis."""
    x = args[0] if args else kwargs.get("input")
    if not isinstance(x, torch.Tensor) or x.dim() != 5:
        return False
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if dim is None:
        return True
    if not isinstance(dim, (int, tuple, list)):
        return False
    dims = {d % 5 for d in ((dim,) if isinstance(dim, int) else dim)}
    return bool(dims & {2, 3})


class HSplit(torch.Tensor):
    """An activation of which this rank holds its band of rows."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _WINDOWED or (name in _REDUCTIONS
                                 and _reduces_height(args, kwargs)):
            raise RuntimeError(
                f"{name} of a height-split activation (TPU.SPATIAL_SHARD): "
                "the op spans the height and is not served by "
                "parallel/spatial.py")
        return super().__torch_function__(func, types, args, kwargs)


def plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a plain tensor (the same memory and autograd history)."""
    return x.as_subclass(torch.Tensor) if isinstance(x, HSplit) else x


def as_split(x: torch.Tensor) -> torch.Tensor:
    return x.as_subclass(HSplit)


def like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` split where ``x`` is."""
    return as_split(y) if isinstance(x, HSplit) else y


def is_split(x) -> bool:
    return isinstance(x, HSplit)


def spatial_shard(cfg) -> int:
    """S of ``cfg``: ``TPU.SPATIAL_SHARD`` above 1, else 1."""
    s = int(cfg.TPU.SPATIAL_SHARD)
    return s if s > 1 else 1


def _group():
    return distributed.space_group()


def _all_gather(t: torch.Tensor) -> list:
    """The group's ``t`` (contiguous, the same shape on every rank), in
    space order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(distributed.space_size())]
    dist.all_gather(parts, t, group=_group())
    return parts


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, group=_group())
    return t


def _bthwc(x: torch.Tensor) -> torch.Tensor:
    """The (B, T, H, W, C) view of an NCDHW tensor (contiguous where x is
    channels-last, as activations are): H is its axis 2."""
    return x.permute(0, 2, 3, 4, 1)


def _ncdhw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 4, 1, 2, 3)


class _Halo(torch.autograd.Function):
    """x's band with ``above`` rows of the rank above and ``below`` rows
    of the rank below, ``fill`` beyond the frame's edges. Backward: each
    halo row's gradient is added to the row it came from."""

    @staticmethod
    def forward(ctx, x, above: int, below: int, fill: float):
        s, r = distributed.space_size(), distributed.space_rank()
        v = _bthwc(x)
        h = v.shape[2]
        parts = _all_gather(torch.cat([v[:, :, :below], v[:, :, h - above:]],
                                      dim=2))
        shape = list(v.shape)
        shape[2] = above

        def edge(n):
            shape[2] = n
            return v.new_full(shape, fill)

        top = parts[r - 1][:, :, below:] if r > 0 else edge(above)
        bottom = parts[r + 1][:, :, :below] if r < s - 1 else edge(below)
        ctx.rows = (above, below, h)
        return _ncdhw(torch.cat([top, v, bottom], dim=2))

    @staticmethod
    def backward(ctx, g):
        above, below, h = ctx.rows
        s, r = distributed.space_size(), distributed.space_rank()
        v = _bthwc(g)
        parts = _all_gather(torch.cat([v[:, :, :above],
                                       v[:, :, above + h:]], dim=2))
        dx = v[:, :, above:above + h].clone()
        if r < s - 1 and above:  # the rank below's top rows are my last
            dx[:, :, h - above:] += parts[r + 1][:, :, :above]
        if r > 0 and below:  # the rank above's bottom rows are my first
            dx[:, :, :below] += parts[r - 1][:, :, above:]
        return _ncdhw(dx), None, None, None


def halo(x: torch.Tensor, above: int, below: int,
         fill: float = 0.0) -> torch.Tensor:
    """The plain NCDHW band ``x`` with its halo rows (``_Halo``); every
    rank of the group passes the same ``above`` and ``below``."""
    if not above and not below:
        return plain(x)
    return _Halo.apply(plain(x), above, below, fill)


class _Gather(torch.autograd.Function):
    """The group's bands of ``x`` joined along axis ``dim`` (whole on
    every rank). Backward: the gradient summed over the group, each rank
    its band (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return torch.cat(_all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.clone())
        return g.narrow(ctx.dim, distributed.space_rank() * ctx.n,
                        ctx.n), None


def gather_height(x: torch.Tensor) -> torch.Tensor:
    """A split NCDHW activation whole on every rank (plain, channels-last
    memory); anything else as it is."""
    if not is_split(x):
        return x
    return _ncdhw(_Gather.apply(_bthwc(plain(x)), 2))


def gather_pathway(x: torch.Tensor) -> torch.Tensor:
    """A split (B, T, H, W, C) pathway (``constrain``'s band) whole on
    every rank (plain); anything else as it is."""
    if not is_split(x):
        return x
    return _Gather.apply(plain(x), 2)


def gather_tokens(t: torch.Tensor) -> torch.Tensor:
    """Split (B, N/S, C) tokens (a band's, in (T, h, W) order) as all N of
    the group, band by band (plain); anything else as it is."""
    if not is_split(t):
        return t
    return _Gather.apply(plain(t), 1)


def global_count(t: torch.Tensor, n: int) -> int:
    """The group's count of what ``t`` holds ``n`` of: n·S where ``t`` is
    split."""
    return n * distributed.space_size() if is_split(t) else n


class _Sum(torch.autograd.Function):
    """The group's sum (whole on every rank); backward the same sum."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone())


def mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim, keepdim)``; over a split height, the group's sum of
    each band's sum over the count of the whole frame (float32 sums,
    the result in x's dtype)."""
    if not is_split(x):
        return x.mean(dim=dim, keepdim=keepdim)
    xp = plain(x)
    count = 1
    for d in dim:
        count *= xp.shape[d]
    total = _Sum.apply(xp.sum(dim=dim, keepdim=keepdim, dtype=torch.float32))
    return (total / (count * distributed.space_size())).to(x.dtype)


def window(x: torch.Tensor, k: int, s: int, p: int, d: int = 1,
           fill: float = 0.0):
    """How an op of kernel ``k``, stride ``s``, padding ``p`` and dilation
    ``d`` along the height runs on the NCDHW ``x``: (its input, the height
    padding to give it, whether its output is split).

    A split ``x`` gets its halo rows (``p`` above, the kernel's reach
    below) where the op's output rows fall as whole bands, output row j
    on the rank that holds input row s·j: the band's height a multiple of
    s, the output height H/s, the halos no taller than a band. Otherwise
    the op takes the whole height (``gather_height``) and its output is
    whole: the fallback of the stage (a long cycle's 158² crop; s5 at a
    224² crop, 14 → 7 rows)."""
    if not is_split(x):
        return x, p, False
    if k == 1 and s == 1 and p == 0:
        return plain(x), 0, True
    h = x.shape[3]
    big = h * distributed.space_size()
    reach = d * (k - 1) + 1
    below = reach - s - p
    if h % s or ((big + 2 * p - reach) // s + 1) * s != big or p > h \
            or below > h:
        return gather_height(x), p, False
    xp = plain(x)
    if below < 0:
        xp, below = xp.narrow(3, 0, h + below), 0
    return halo(xp, p, below, fill), 0, True


def constrain(cfg, pathways):
    """The pathways (B, T, H, W, C) of the ``CROP_SIZE`` grid as this
    rank's bands (``HSplit``) where ``TPU.SPATIAL_SHARD`` splits them and
    S divides H; as they are otherwise (``mesh.py::constrain_spatial``).
    Bands stay bands; a job whose space groups are not S ranks raises."""
    s = spatial_shard(cfg)
    if s == 1:
        return pathways
    if distributed.space_size() != s:
        raise RuntimeError(
            f"TPU.SPATIAL_SHARD={s} needs a job whose space groups are {s} "
            f"processes (this one's are {distributed.space_size()}): "
            "start it with utils/misc.py::launch_job")
    r = distributed.space_rank()
    out = []
    for x in pathways:
        h = x.shape[2]
        if is_split(x) or x.dim() != 5 or h % s:
            out.append(x)
            continue
        out.append(as_split(x.narrow(2, r * (h // s), h // s).contiguous()))
    return out
