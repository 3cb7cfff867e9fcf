"""Batch normalization (port of ``ops/norm.py``: ``BatchNorm3d``,
``SubBatchNorm3d``, the sub-BN conversions and ``get_norm``).

The JAX package wraps ``flax.linen.BatchNorm`` (momentum 1-m, two-pass
variance); the port keeps torch's ``nn.BatchNorm3d`` (the reference's
layer), with eps 1e-5 and momentum m in torch's convention, new = (1-m)*old
+ m*batch. Parameters and running statistics stay float32 while the
activations run in the compute dtype.

- Eval: the running statistics, as ``nn.BatchNorm3d``.
- Train: the batch statistics over (B, T, H, W), computed in float32 from
  the activations (bf16 ones included) and normalising with the biased
  variance, as both frameworks do. The running variance is where they part:
  torch updates it with the unbiased batch variance, n/(n-1) times the
  biased one, flax with the biased one. The port updates it as flax does,
  under ``no_grad``: torch's fused update, then the exact correction
  new·(n-1)/n + old·(1-m)/n, so that new = (1-m)·old + m·biased.
- ``update_stats`` False normalises with the batch statistics and leaves the
  running ones as they are: a rematerialised stage's recompute runs its
  BN a second time, and flax's ``nn.remat`` updates ``batch_stats`` once.

``SubBatchNorm3d`` (``BN.NORM_TYPE sub_batchnorm``, which multigrid
training switches to when a card holds more than ``BN_BASE_SIZE`` clips)
normalises each of ``num_splits`` groups of the batch with its own
statistics. Its state_dict has the reference's names (PySlowFast's
batchnorm_helper.py:37-109): the shared ``weight`` and ``bias``, the
aggregated statistics in ``bn`` and the per-split ones in ``split_bn``
(``num_splits`` x C, split-major). The groups are the JAX package's:
contiguous runs of B / num_splits clips (the reference interleaves them).
The conversions between the two forms work on state dicts, as the
reference's checkpoint helpers do.

Across processes a module sees its rank's rows of the global batch, and
its train-mode statistics are the global batch's, as under the JAX
package's SPMD step: one grouped form (``grouped_batch_norm``) combines
each rank's count, mean and variance of its rows of a group exactly (one
all-reduce; JAX takes a two-pass variance) and, in the backward, reduces
the group's Σdy and Σdy·(x - mean) (another).
Plain BN is one group of the global batch; sync-BN (``SyncBatchNorm3d``)
``NUM_SYNC_DEVICES``-rank groups of it (one group, plain BN, when they
span the run); sub-BN ``NUM_SPLITS x world`` contiguous splits of it, as
JAX multiplies by its data axis. In one process the modules run
``F.batch_norm`` as before.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.distributed import all_reduce_sum, rank, world_size


def _segments(b: int, groups: int) -> list:
    """[(first row, end row, group)] of this rank's ``b`` rows of the
    global batch (every rank's rows in rank order, equal counts) cut into
    ``groups`` contiguous groups: the runs of its rows in one group."""
    w, r = world_size(), rank()
    total = b * w
    if total % groups:
        raise ValueError(f"global batch {total} ({w} x {b}) not divisible "
                         f"into {groups} BN groups")
    size, out, a = total // groups, [], r * b
    while a < (r + 1) * b:
        e = min((a // size + 1) * size, (r + 1) * b)
        out.append((a - r * b, e - r * b, a // size))
        a = e
    return out


class _GroupedNorm(torch.autograd.Function):
    """Train-mode BN of this rank's rows ``x`` with each group's statistics
    over every rank: y in x's dtype, and the groups' (G, C) float32 means
    and biased variances. Each rank's (count, mean, variance) of each of
    its runs go to every rank in one all-reduce and combine exactly (the
    mean of the means weighted by the counts; the variance as the mean of
    the variances plus that of the means about the group's); the
    backward reduces each group's Σdy and Σdy·(x - mean) in another,
    unless ``local``: every group within one rank, as sub-BN's
    ``NUM_SPLITS x world`` splits are, where those sums are the rank's
    own. Saved for the backward: x itself, as cuDNN's BN saves it."""

    @staticmethod
    def forward(ctx, x, weight, bias, segments, groups: int, eps: float,
                local: bool):
        c = x.shape[1]
        axes = (0,) + tuple(range(2, x.dim()))
        slots = torch.zeros(world_size(), groups, 2 * c + 1,
                            dtype=torch.float32, device=x.device)
        mine = slots[rank()]
        for a, e, g in segments:
            var, mean = torch.var_mean(x[a:e].float(), dim=axes,
                                       correction=0)
            mine[g, 0] = x[a:e].numel() // c
            mine[g, 1:c + 1] = mean
            mine[g, c + 1:] = var
        all_reduce_sum(slots)
        n = slots[..., :1]
        count = n.sum(0)
        mean = (n * slots[..., 1:c + 1]).sum(0) / count
        var = (n * (slots[..., c + 1:] + (slots[..., 1:c + 1] - mean)
                    .square())).sum(0) / count
        ys = [F.batch_norm(x[a:e], mean[g], var[g], weight, bias, False, 0.0,
                           eps) for a, e, g in segments]
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), count)
        ctx.segments, ctx.local = segments, local
        ctx.mark_non_differentiable(mean, var)
        return (ys[0] if len(ys) == 1 else torch.cat(ys)), mean, var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.shape[1]
        axes = (0,) + tuple(range(2, x.dim()))
        view = (1, c) + (1,) * (x.dim() - 2)
        sums = torch.zeros(mean.shape[0], 2 * c, dtype=torch.float32,
                           device=x.device)
        parts, gw, gb = [], torch.zeros_like(weight), torch.zeros_like(weight)
        for a, e, g in ctx.segments:
            dy = gy[a:e].float()
            xmu = x[a:e].float() - mean[g].view(view)
            sdy, sdx = dy.sum(axes), (dy * xmu).sum(axes)
            sums[g, :c] += sdy
            sums[g, c:] += sdx
            gw += sdx * invstd[g]
            gb += sdy
            parts.append((dy, xmu, g))
        if not ctx.local:
            all_reduce_sum(sums)
        sums = sums / count
        dxs = []
        for dy, xmu, g in parts:
            k = invstd[g] * weight
            dx = (dy - sums[g, :c].view(view) - xmu * (
                invstd[g].square() * sums[g, c:]).view(view)) * k.view(view)
            dxs.append(dx.to(x.dtype))
        dx = dxs[0] if len(dxs) == 1 else torch.cat(dxs)
        return dx, gw, gb, None, None, None, None


def grouped_batch_norm(x, weight, bias, groups: int, eps: float):
    """Train-mode BN of this rank's rows ``x`` of the global batch (every
    rank's rows in rank order, equal counts), cut into ``groups``
    contiguous groups, each normalized by its own statistics over the
    ranks: (y in x's dtype, (G, C) float32 means, biased variances)."""
    b = x.shape[0]
    local = b % (b * world_size() // groups) == 0  # the same on every rank
    return _GroupedNorm.apply(x, weight, bias, _segments(b, groups), groups,
                              eps, local)


class BatchNorm3d(nn.BatchNorm3d):
    """BN over (B, T, H, W) of an NCDHW tensor; float32 statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, zero_init_gamma: bool = False,
                 device=None):
        self.zero_init_gamma = zero_init_gamma
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=device)
        self.update_stats = True

    def reset_parameters(self) -> None:
        super().reset_parameters()
        if self.zero_init_gamma:
            nn.init.zeros_(self.weight)

    num_groups = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if world_size() > 1 or self.num_groups > 1:
            return self._grouped(x)
        # copies: autograd keeps the statistics it was given, which must
        # not change before the backward; the recompute of a remat stage
        # runs the same op (the checkpoint checks that it saves the same
        # tensors) and drops its update
        m = self.momentum
        n = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m,
                         self.eps)
        if self.update_stats:
            with torch.no_grad():  # unbiased → biased batch variance
                self.running_mean.copy_(mean)
                self.running_var.mul_((1 - m) / n).add_(var,
                                                         alpha=(n - 1) / n)
                self.num_batches_tracked += 1
        return y

    def _grouped(self, x):
        """Train mode across ranks: the statistics of ``num_groups``
        groups of the global batch; the running ones move towards their
        aggregate (the mean of the means, the mean of the variances plus
        the variance of the means), as JAX's SyncBatchNorm3d updates."""
        y, mean, var = grouped_batch_norm(x, self.weight, self.bias,
                                          self.num_groups, self.eps)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                agg_mean, agg_var = _aggregate(mean, var)
                self.running_mean.mul_(1 - m).add_(agg_mean, alpha=m)
                self.running_var.mul_(1 - m).add_(agg_var, alpha=m)
                self.num_batches_tracked += 1
        return y


class SyncBatchNorm3d(BatchNorm3d):
    """Sync-BN of ``num_groups`` groups (port of ``ops/norm.py:161-258``;
    reference: batchnorm_helper.py:174-218): ``BN.NUM_SYNC_DEVICES``
    consecutive ranks share their statistics, which are contiguous rows
    of the global batch. The state_dict is plain BN's."""

    def __init__(self, num_features: int, num_groups: int = 1, **kw):
        super().__init__(num_features, **kw)
        self.num_groups = num_groups


class SubBatchNorm3d(nn.Module):
    """Split-batch BN (port of ``ops/norm.py:67-158``).

    Train: the batch is cut into ``num_splits`` contiguous groups, each
    normalised with its own batch statistics, which update its own running
    statistics (``split_bn``) as ``BatchNorm3d`` updates its (biased
    variance, ``update_stats``). Eval: the aggregated statistics in ``bn``
    (``aggregate_stats``). The affine ``weight`` and ``bias`` are shared.
    """

    def __init__(self, num_features: int, num_splits: int = 1,
                 eps: float = 1e-5, momentum: float = 0.1,
                 zero_init_gamma: bool = False, device=None):
        super().__init__()
        self.num_features = num_features
        self.num_splits = num_splits
        self.eps = eps
        self.momentum = momentum
        self.zero_init_gamma = zero_init_gamma
        self.update_stats = True
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        # buffers only: the forward runs the statistics itself
        self.bn = nn.BatchNorm3d(num_features, eps=eps, momentum=momentum,
                                 affine=False, device=device)
        self.split_bn = nn.BatchNorm3d(num_features * num_splits, eps=eps,
                                       momentum=momentum, affine=False,
                                       device=device)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        if self.zero_init_gamma:
            nn.init.zeros_(self.weight)
        else:
            nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def aggregate_stats(self) -> None:
        """The eval statistics from the splits': the mean of their means
        and the mean of their variances plus the variance of their means
        (reference :98-109)."""
        c = self.num_features
        mean, var = _aggregate(self.split_bn.running_mean.view(-1, c),
                               self.split_bn.running_var.view(-1, c))
        self.bn.running_mean.copy_(mean)
        self.bn.running_var.copy_(var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.bn.running_mean, self.bn.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        k, c, m = self.num_splits, self.num_features, self.momentum
        if world_size() > 1:
            return self._grouped(x)
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"BN.NUM_SPLITS={k}")
        parts = x.chunk(k)
        n = parts[0].numel() // c
        ys, stats = [], []
        for i, part in enumerate(parts):
            # a copy for each split (see BatchNorm3d.forward)
            rows = slice(i * c, (i + 1) * c)
            mean = self.split_bn.running_mean[rows].clone()
            var = self.split_bn.running_var[rows].clone()
            ys.append(F.batch_norm(part, mean, var, self.weight, self.bias,
                                   True, m, self.eps))
            stats.append((rows, mean, var))
        if self.update_stats:
            with torch.no_grad():  # unbiased → biased batch variance
                for rows, mean, var in stats:
                    self.split_bn.running_mean[rows].copy_(mean)
                    self.split_bn.running_var[rows].mul_((1 - m) / n).add_(
                        var, alpha=(n - 1) / n)
                self.split_bn.num_batches_tracked += 1
        return torch.cat(ys)

    def _grouped(self, x):
        """Train mode across ranks: the splits are contiguous groups of
        the global batch, whose statistics may span two ranks."""
        k, c, m = self.num_splits, self.num_features, self.momentum
        y, mean, var = grouped_batch_norm(x, self.weight, self.bias, k,
                                          self.eps)
        if self.update_stats:
            with torch.no_grad():
                self.split_bn.running_mean.view(k, c).mul_(1 - m).add_(
                    mean, alpha=m)
                self.split_bn.running_var.view(k, c).mul_(1 - m).add_(
                    var, alpha=m)
                self.split_bn.num_batches_tracked += 1
        return y


def _aggregate(split_mean: torch.Tensor, split_var: torch.Tensor):
    mean = split_mean.mean(0)
    var = split_var.mean(0) + (split_mean - mean).square().mean(0)
    return mean, var


def aggregate_sub_bn_stats(module: nn.Module) -> int:
    """Every ``SubBatchNorm3d`` of ``module`` takes its eval statistics
    from its splits' (``aggregate_stats``); returns how many there were
    (reference: utils/misc.py:257-272)."""
    count = 0
    for m in module.modules():
        if isinstance(m, SubBatchNorm3d):
            with torch.no_grad():
                m.aggregate_stats()
            count += 1
    return count


# state-dict conversions between the plain and the split form of BN; a BN
# is named by its prefix, "s2.pathway0_res0.branch2.a_bn." (the root's "")
_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _sub_prefixes(sd) -> list:
    tail = "split_bn.running_mean"
    return [k[:-len(tail)] for k in sd if k.endswith(tail)]


def _normal_prefixes(sd) -> list:
    inner = {p + s for p in _sub_prefixes(sd) for s in ("bn.", "split_bn.")}
    tail = "running_mean"
    return [k[:-len(tail)] for k in sd
            if k.endswith(tail) and k[:-len(tail)] not in inner]


def _splits(sd, p) -> int:
    return (sd[p + "split_bn.running_mean"].numel()
            // sd[p + "bn.running_mean"].numel())


def _as_normal(sd, p) -> dict:
    """BN ``p``'s statistics in the plain form; a split BN's aggregated
    from its splits (as ``aggregate_stats``), its step count the splits'."""
    if p + "split_bn.running_mean" not in sd:
        return {p + s: sd[p + s] for s in _STATS}
    c = sd[p + "bn.running_mean"].numel()
    mean, var = _aggregate(sd[p + "split_bn.running_mean"].view(-1, c),
                           sd[p + "split_bn.running_var"].view(-1, c))
    return {p + "running_mean": mean, p + "running_var": var,
            p + "num_batches_tracked":
                sd[p + "split_bn.num_batches_tracked"].clone()}


def _as_sub(stats, p, num_splits) -> dict:
    """Plain statistics ``stats`` of BN ``p`` in the split form, every
    split starting from them."""
    mean, var, count = (stats[p + s] for s in _STATS)
    return {p + "bn.running_mean": mean, p + "bn.running_var": var,
            p + "bn.num_batches_tracked": count,
            p + "split_bn.running_mean": mean.repeat(num_splits),
            p + "split_bn.running_var": var.repeat(num_splits),
            p + "split_bn.num_batches_tracked": count.clone()}


def _owner(key, groups):
    """The BN prefix of ``groups`` whose statistic ``key`` is, or None."""
    for s in _STATS:
        if not key.endswith(s):
            continue
        head = key[:-len(s)]
        cands = [head]
        for inner in ("split_bn.", "bn."):
            if head.endswith(inner):
                cands.append(head[:-len(inner)])
        return next((c for c in cands if c in groups), None)
    return None


def _replace(sd, groups) -> "OrderedDict":
    """``sd`` with each BN ``p`` of ``groups`` holding ``groups[p]`` as its
    statistics, where its old ones stood; everything else as it was."""
    out, done = OrderedDict(), set()
    for key, v in sd.items():
        p = _owner(key, groups)
        if p is None:
            out[key] = v
        elif p not in done:
            out.update(groups[p])
            done.add(p)
    return out


def sub_to_normal_bn(state_dict) -> "OrderedDict":
    """Every split BN of ``state_dict`` in the plain form, its statistics
    aggregated from the splits' (the form the reference saves; its
    checkpoint.py:290-330)."""
    return _replace(state_dict, {p: _as_normal(state_dict, p)
                                 for p in _sub_prefixes(state_dict)})


def normal_to_sub_bn(state_dict, num_splits: int) -> "OrderedDict":
    """Every BN of ``state_dict`` in the split form with ``num_splits``
    splits, each starting from the BN's statistics: a plain BN's running
    ones, a split BN with another count its aggregated ones (reference
    checkpoint.py:333-389)."""
    groups = {p: _as_sub(_as_normal(state_dict, p), p, num_splits)
              for p in _normal_prefixes(state_dict)}
    for p in _sub_prefixes(state_dict):
        if _splits(state_dict, p) != num_splits:
            stats = {p + s: state_dict[p + "bn." + s] for s in _STATS}
            groups[p] = _as_sub(stats, p, num_splits)
    return _replace(state_dict, groups)


def adapt_bn_stats_to(target, state_dict) -> "OrderedDict":
    """``state_dict``'s BN statistics in the form of ``target`` (a state
    dict of the model they go into), BN by BN: split where the target
    splits (from the aggregate where the counts differ), plain where it
    does not."""
    groups = {}
    for p in _sub_prefixes(target):
        k = _splits(target, p)
        if (p + "split_bn.running_mean" not in state_dict
                or _splits(state_dict, p) != k):
            groups[p] = _as_sub(_as_normal(state_dict, p), p, k)
    for p in _normal_prefixes(target):
        if p + "split_bn.running_mean" in state_dict:
            groups[p] = _as_normal(state_dict, p)
    return _replace(state_dict, groups)


def convert_bn_stats(state_dict, old_type: str, new_type: str,
                     num_splits: int):
    """``state_dict``'s BN statistics across a change of ``BN.NORM_TYPE``
    at a multigrid phase boundary (the same dict where the forms agree)."""
    if new_type == "sub_batchnorm":
        return normal_to_sub_bn(state_dict, num_splits)
    if old_type == "sub_batchnorm":
        return sub_to_normal_bn(state_dict)
    return state_dict


def effective_num_splits(cfg) -> int:
    """The split count of a ``SubBatchNorm3d``: ``BN.NUM_SPLITS`` groups of
    each rank's batch, so ``NUM_SPLITS`` x world groups of the global
    batch, as the JAX package multiplies by its data axis (one device a
    rank)."""
    return max(1, int(cfg.BN.NUM_SPLITS)) * world_size()


def effective_sync_groups(cfg) -> int:
    """Statistics groups of sync-BN (reference: batchnorm_helper.py
    :174-192): ``BN.NUM_SYNC_DEVICES``-sized groups of the run's devices,
    one per process here; 0, or a group spanning every process, is one
    global group."""
    n = world_size()
    sync = int(cfg.BN.NUM_SYNC_DEVICES)
    if sync <= 0 or sync >= n:
        return 1
    if n % sync != 0:
        raise ValueError(
            f"BN.NUM_SYNC_DEVICES={sync} does not divide the process "
            f"count {n} (reference asserts local_size % num_sync == 0, "
            f"batchnorm_helper.py:184-188)")
    return n // sync


def get_norm(cfg):
    """Norm-module factory from config (reference: batchnorm_helper.py:15-34)."""
    kwargs = dict(eps=cfg.BN.EPSILON, momentum=cfg.BN.MOMENTUM)
    if cfg.BN.NORM_TYPE == "batchnorm":
        return functools.partial(BatchNorm3d, **kwargs)
    if cfg.BN.NORM_TYPE == "sub_batchnorm":
        return functools.partial(SubBatchNorm3d,
                                 num_splits=effective_num_splits(cfg), **kwargs)
    if cfg.BN.NORM_TYPE == "sync_batchnorm":
        groups = effective_sync_groups(cfg)
        if groups == 1:
            # one group, the global batch, which plain BN computes (the
            # JAX package's one-group case, get_norm:471-476)
            return functools.partial(BatchNorm3d, **kwargs)
        return functools.partial(SyncBatchNorm3d, num_groups=groups, **kwargs)
    raise NotImplementedError(f"Norm type {cfg.BN.NORM_TYPE} is not supported")
