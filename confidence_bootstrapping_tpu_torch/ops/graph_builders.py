"""Fixed-capacity padded neighbour lists and masked scatters.

Port of ``confidence_bootstrapping_tpu/ops/graph_builders.py``. Distances are
dense masked matrices; capped neighbour lists come from ``torch.topk``. Ties
may be ordered differently from ``lax.top_k``: neighbour sets and message sums
agree, raw index order need not.
"""

from __future__ import annotations

import torch

_BIG = 1e9


def pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, 3], b [..., N, 3] -> [..., M, N] Euclidean distances."""
    d2 = torch.sum((a[..., :, None, :] - b[..., None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def radius_mask(a, b, cutoff, a_mask, b_mask, exclude_self: bool = False):
    """(mask, dist): True where |a_i - b_j| < cutoff and both are valid.
    ``cutoff`` is a float or a tensor broadcastable to [..., 1, 1]."""
    d = pairwise_dist(a, b)
    m = (d < cutoff) & a_mask[..., :, None] & b_mask[..., None, :]
    if exclude_self:
        m = m & ~torch.eye(a.shape[-2], b.shape[-2], dtype=torch.bool, device=a.device)
    return m, d


def topk_neighbors(a, b, cutoff, a_mask, b_mask, k: int, exclude_self: bool = False):
    """For each a_i, up to k nearest b_j within cutoff, nearest first.
    Returns (idx [..., M, k] int64, mask [..., M, k], dist [..., M, k])."""
    m, d = radius_mask(a, b, cutoff, a_mask, b_mask, exclude_self)
    d_masked = torch.where(m, d, torch.full_like(d, _BIG))
    neg, idx = torch.topk(-d_masked, k, dim=-1)
    dist = -neg
    return idx, dist < _BIG / 2, dist


def count_overflow(a, b, cutoff, a_mask, b_mask, k: int, exclude_self: bool = False) -> torch.Tensor:
    """Number of rows i whose true neighbour count within ``cutoff`` exceeds
    the capacity k."""
    m, _ = radius_mask(a, b, cutoff, a_mask, b_mask, exclude_self)
    return torch.sum(torch.sum(m, dim=-1) > k)


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], idx [B, ..., K] -> [B, ..., K, D]."""
    B = x.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def scatter_mean_to_nodes(values, idx, mask, num_nodes: int):
    """Segment-sum messages onto nodes -> (sums [B, N, D], counts [B, N]).
    values [B, M, D], idx [B, M] destination node, mask [B, M]."""
    B, M, D = values.shape
    flat_idx = torch.where(mask, idx.long(), torch.zeros_like(idx.long()))
    v = torch.where(mask[..., None], values, torch.zeros_like(values))
    sums = torch.zeros(B, num_nodes, D, dtype=values.dtype, device=values.device)
    sums.scatter_add_(1, flat_idx[..., None].expand(-1, -1, D), v)
    return sums, scatter_count_to_nodes(idx, mask, num_nodes)


def scatter_count_to_nodes(idx, mask, num_nodes: int) -> torch.Tensor:
    """[B, N] float counts of the valid entries of idx [B, M]."""
    B = idx.shape[0]
    flat_idx = torch.where(mask, idx.long(), torch.zeros_like(idx.long()))
    cnts = torch.zeros(B, num_nodes, dtype=torch.float32, device=idx.device)
    cnts.scatter_add_(1, flat_idx, mask.to(torch.float32))
    return cnts
