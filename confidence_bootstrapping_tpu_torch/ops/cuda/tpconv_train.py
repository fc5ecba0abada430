"""Differentiable TP-conv ops for training (``torch.autograd.Function``).

Replaces ``confidence_bootstrapping_tpu/ops/pallas/tpconv_train.py``'s two
``jax.custom_vjp`` ops:

* ``fused_tpconv_train``: edge MLP -> dropout -> weighted TP -> mask ->
  optional K-sum over pre-gathered edge lists [M, K, *]. Forward: the
  edge-list kernel (``tpconv_edge``); backward: the edge backward kernel
  (``tpconv_bwd``) on the cotangent broadcast over K (for the K-sum) and
  masked, given the mask, so that its tensor-core build skips masked edges.
* ``fused_tpconv_rec_train``: the receptor kNN groups (senders and receivers
  one node table). Forward: the in-kernel-gather kernel with the dropout mask
  (``tpconv_rec`` on the lmax=1 irreps ladder, ``tpconv_rec_g`` on the
  general route: lmax=2, or the second-order ladder at lmax=1). Backward: the
  per-edge sender, harmonics and MLP input rebuilt in plain PyTorch, the edge
  backward kernel, ``d_sender`` scattered to the node table with
  ``index_add_``, and ``d_pos`` through the harmonics' autograd.

``mask``, ``dmask`` and the neighbour indices get no gradient. On CPU tensors
every kernel wrapper runs its plain version, so these ops are the JAX
package's composition there.
"""

from __future__ import annotations

import torch

from ..irreps import Irreps
from .tpconv_bwd import edge_bwd
from .tpconv_common import SH_IRREPS, is_ladder, sh_kernel
from .tpconv_edge import fused_tpconv_edge
from .tpconv_g import fused_tpconv_rec_g
from .tpconv_rec import fused_tpconv_rec


class _EdgeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_attr, sender, sh, mask, dmask, w1, b1, w2, b2, irreps, sum_k, packed):
        ctx.irreps, ctx.sum_k = irreps, sum_k
        ctx.save_for_backward(edge_attr, sender, sh, mask, dmask, w1, b1, w2, b2)
        return fused_tpconv_edge(edge_attr, sender, sh, mask, w1, b1, w2, b2, *irreps, dmask=dmask, sum_k=sum_k,
                                 packed=packed)

    @staticmethod
    def backward(ctx, g):
        edge_attr, sender, sh, mask, dmask, w1, b1, w2, b2 = ctx.saved_tensors
        M, K, F = edge_attr.shape
        ge = (g[:, None, :].expand(M, K, g.shape[-1]) if ctx.sum_k else g) * mask[..., None]
        T = M * K
        d_a, d_x, d_s, dw1, db1, dw2, db2 = edge_bwd(
            edge_attr.reshape(T, F), sender.reshape(T, -1), sh.reshape(T, -1), ge.reshape(T, -1).contiguous(),
            None if dmask is None else dmask.reshape(T, -1), w1, b1, w2, b2, *ctx.irreps, valid=mask.reshape(T))
        return (d_a.reshape(edge_attr.shape), d_x.reshape(sender.shape), d_s.reshape(sh.shape), None, None,
                dw1, db1, dw2, db2, None, None, None)


def fused_tpconv_train(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_sh: str, irreps_out: str,
                       dmask=None, sum_k: bool = True, packed=None):
    """Differentiable (edge MLP -> dropout -> weighted TP -> mask -> optional
    K-sum). edge_attr [M, K, F], sender [M, K, Din], sh [M, K, Dsh], mask
    [M, K] bool, dmask None or [M, K, H'] ({0, 1/keep}). Returns [M, Dout]
    (sum_k) or [M, K, Dout], canonical irreps layout. Gradients flow to
    edge_attr, sender, sh and the MLP's weights; ``packed``: the forward's
    kernel-layout weights (``pack_weights``), made per call when None."""
    irreps = tuple(str(Irreps(i)) for i in (irreps_in, irreps_sh, irreps_out))
    c = lambda t: None if t is None else t.contiguous()
    return _EdgeTrain.apply(c(edge_attr), c(sender), c(sh), c(mask), c(dmask), w1, b1, w2, b2, irreps, bool(sum_k),
                            packed)


class _RecTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node_attr, pos, nbr, edge_emb, sig, mask, dmask, w1, b1, w2, b2, irreps, ns, packed):
        ctx.irreps, ctx.ns = irreps, ns
        ctx.save_for_backward(node_attr, pos, nbr, edge_emb, sig, mask, dmask, w1, b1, w2, b2)
        irreps_in, irreps_sh, irreps_out = irreps
        if irreps_sh != str(Irreps(SH_IRREPS)) or not is_ladder(irreps_in, irreps_out):
            return fused_tpconv_rec_g(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_sh,
                                      irreps_out, ns, packed=packed, dmask=dmask)
        return fused_tpconv_rec(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns,
                                packed=packed, dmask=dmask)

    @staticmethod
    def backward(ctx, g):
        node_attr, pos, nbr, edge_emb, sig, mask, dmask, w1, b1, w2, b2 = ctx.saved_tensors
        ns = ctx.ns
        B, N, Din = node_attr.shape
        K, Fe = nbr.shape[2], edge_emb.shape[-1]
        T = B * N * K
        flat_nbr = (nbr + torch.arange(B, device=nbr.device)[:, None, None] * N).reshape(-1)
        # rebuild the per-edge tensors the forward kernel never wrote
        sender = node_attr.reshape(B * N, Din).index_select(0, flat_nbr).reshape(B, N, K, Din)
        vec = (pos.reshape(B * N, 3).index_select(0, flat_nbr).reshape(B, N, K, 3) - pos[:, :, None, :]).detach()
        need_pos = ctx.needs_input_grad[1]
        with torch.enable_grad():
            vec.requires_grad_(need_pos)
            sh = sh_kernel(vec, ctx.irreps[1])
        eattr = torch.cat([edge_emb + sig[:, None, None, :], node_attr[:, :, None, :ns].expand(B, N, K, ns),
                           sender[..., :ns]], dim=-1)
        ge = g[:, :, None, :] * mask[..., None]
        d_a, d_x, d_s, dw1, db1, dw2, db2 = edge_bwd(
            eattr.reshape(T, -1), sender.reshape(T, Din), sh.detach().reshape(T, -1), ge.reshape(T, -1),
            None if dmask is None else dmask.reshape(T, -1), w1, b1, w2, b2, *ctx.irreps, valid=mask.reshape(T))
        d_eattr = d_a.reshape(B, N, K, -1)
        d_edge_emb = d_eattr[..., :Fe]
        d_sender = d_x.reshape(B, N, K, Din).clone()
        d_sender[..., :ns] += d_eattr[..., Fe + ns:]
        d_node = torch.zeros(B * N, Din, dtype=d_x.dtype, device=d_x.device)
        d_node.index_add_(0, flat_nbr, d_sender.reshape(T, Din))
        d_node = d_node.reshape(B, N, Din)
        d_node[..., :ns] += d_eattr[..., Fe:Fe + ns].sum(dim=2)
        d_pos = None
        if need_pos:
            (d_vec,) = torch.autograd.grad(sh, vec, d_s.reshape(sh.shape))
            d_pos = torch.zeros(B * N, 3, dtype=d_vec.dtype, device=d_vec.device)
            d_pos.index_add_(0, flat_nbr, d_vec.reshape(T, 3))
            d_pos = d_pos.reshape(B, N, 3) - d_vec.sum(dim=2)
        return (d_node, d_pos, None, d_edge_emb, d_edge_emb.sum(dim=(1, 2)), None, None, dw1, db1, dw2, db2, None, None,
                None)


def fused_tpconv_rec_train(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in: str, irreps_sh: str,
                           irreps_out: str, ns: int, dmask=None, packed=None):
    """Differentiable kNN TP-conv over one node table: message sums
    [B, N, Dout]. node_attr [B, N, Din], pos [B, N, 3], nbr [B, N, K] int64,
    edge_emb [B, N, K, Fe], sig [B, Fe] (added to edge_emb), mask [B, N, K]
    bool, dmask None or [B, N, K, H'] ({0, 1/keep}). Gradients flow to
    node_attr, pos (through the harmonics), edge_emb, sig and the MLP's
    weights."""
    irreps = tuple(str(Irreps(i)) for i in (irreps_in, irreps_sh, irreps_out))
    c = lambda t: None if t is None else t.contiguous()
    return _RecTrain.apply(c(node_attr), c(pos), c(nbr), c(edge_emb), c(sig), c(mask), c(dmask), w1, b1, w2, b2,
                           irreps, int(ns), packed)
