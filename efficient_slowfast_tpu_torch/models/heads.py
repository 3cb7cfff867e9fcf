"""Classification heads (reference: slowfast/models/head_helper.py:133-418).

ResNetBasicHead: per-pathway avg-pool → concat channels → dropout → linear;
in eval mode the activation (softmax/sigmoid, in float32) comes BEFORE the
mean over (T', H', W') — the order matters for multi-crop test parity
(:218-221). With a test crop larger than the training crop the head pools
with the training window at stride 1 and averages the activated scores over
the positions (fully convolutional testing). Under ``TPU.SPATIAL_SHARD`` the
head takes the whole height of a split pathway (``spatial.gather_height``),
and its scores are whole on every rank.

Dropout, in train mode only, draws its mask from the ``torch.Generator``
that the caller passes down (the train step always passes one; a direct
call of the module without one draws from torch's default generator):
each element is kept with probability 1-p and scaled by 1/(1-p), as flax's
``nn.Dropout`` does (its bits differ from flax's, so tests that compare
with JAX set the rate to 0).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Linear
from ..ops.pool import avg_pool3d
from ..parallel import spatial
from ..parallel.distributed import global_rows


class ResNetBasicHead(nn.Module):
    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 pool_size: Optional[Sequence[Optional[Sequence[int]]]],
                 dropout_rate: float = 0.0, act_func: str = "softmax",
                 fc_init_std: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(act_func)
        self.pool_size = pool_size
        self.act_func = act_func
        self.dropout_rate = dropout_rate
        self.projection = Linear(sum(dim_in), num_classes,
                                 init_std=fc_init_std, dtype=dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        pools = []
        for p, x in enumerate(inputs):
            # a split height is taken whole: the pool's window spans it,
            # and a larger test crop pools it at every position
            x = spatial.gather_height(x)
            if self.pool_size is None or self.pool_size[p] is None:
                x = x.mean(dim=(2, 3, 4), keepdim=True)
            else:  # summed in float32 (the CPU has no bf16 avg_pool3d)
                x = avg_pool3d(x.float(), self.pool_size[p],
                               stride=(1, 1, 1)).to(x.dtype)
            pools.append(x)
        x = torch.cat(pools, dim=1).permute(0, 2, 3, 4, 1)  # (B,T',H',W',C)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator)
        x = self.projection(x)
        if not self.training:
            x = x.float()
            x = (F.softmax(x, dim=-1) if self.act_func == "softmax"
                 else torch.sigmoid(x))
            x = x.mean(dim=(1, 2, 3))
        return x.reshape(x.shape[0], -1)


class ResNetBasicHeadSlowPath(ResNetBasicHead):
    """The same head over the slow pathway alone, while the trunk still
    computes both (``MODEL.SLOW_PATHWAY_HEAD``; reference:
    head_helper.py:269-418): ``dim_in`` and ``pool_size`` are those of all
    pathways, of which it keeps the first."""

    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 pool_size: Optional[Sequence[Optional[Sequence[int]]]],
                 **kw):
        super().__init__(dim_in[:1], num_classes,
                         None if pool_size is None else pool_size[:1], **kw)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        return super().forward(inputs[:1], generator)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (torch's
    default one where None): x/(1-rate) where a uniform draw is below
    1-rate, else 0. Across processes the mask is this rank's rows of the
    global batch's (``global_rows``)."""
    keep = global_rows(lambda s: torch.rand(s, generator=generator,
                                            device=x.device), x.shape)
    keep = keep < 1 - rate
    return torch.where(keep, x / (1 - rate), torch.zeros_like(x))
