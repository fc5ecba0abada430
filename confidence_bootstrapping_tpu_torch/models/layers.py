"""Building blocks of the equivariant score model.

Port of ``confidence_bootstrapping_tpu/models/layers.py`` for inference:
``FCBlock``, ``AtomEncoder``, ``GaussianSmearing``, ``BatchNormIrreps`` (with
running statistics) and ``TPConv``. ``TPConv``'s receptor, ligand-pair and
cross convolutions go through the CUDA kernels of ``ops/cuda`` for CUDA
tensors and through their plain PyTorch versions for CPU tensors: the lmax=1
kernels for the score model's ``1x0e + 1x1o`` harmonics, the lmax=2 ones
(``rec_g``, ``cross_g``) for the confidence model's ``1x0e + 1x1o + 1x2e``.
The Mosaic-only restrictions of the JAX package (N % 32 or N % 8, N <= 2048,
L % 8, K % 16, K chunks) have no counterpart: the kernels take any N, L and
K and sum every edge.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cuda.tpconv_common import SH2_IRREPS, PackedWeights, pack_weights
from ..ops.cuda.tpconv_g import fused_tpconv_cross_g, fused_tpconv_rec_g
from ..ops.cuda.tpconv_lig import fused_tpconv_cross_rev, fused_tpconv_pb
from ..ops.cuda.tpconv_rec import fused_tpconv_rec
from ..ops.graph_builders import scatter_count_to_nodes
from ..ops.irreps import Irreps, WeightedTensorProduct


class FCBlock(nn.Module):
    """Linear (ReLU Linear) * (depth - 1)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, depth: int = 2):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (depth - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(torch.relu(x) if i else x)
        return x


class AtomEncoder(nn.Module):
    """Sum of categorical embeddings, then a linear fold-in of the scalar
    features (sigma and/or language-model embedding) when there are any."""

    def __init__(self, emb_dim: int, feature_dims: Sequence[int], n_scalar: int = 0):
        super().__init__()
        self.feature_dims = tuple(feature_dims)
        self.embeddings = nn.ModuleList(nn.Embedding(v, emb_dim) for v in self.feature_dims)
        self.layers = nn.ModuleList([nn.Linear(emb_dim + n_scalar, emb_dim)] if n_scalar > 0 else [])

    def forward(self, x_cat, x_scalar=None):
        emb = 0.0
        for i, (table, vocab) in enumerate(zip(self.embeddings, self.feature_dims)):
            # out-of-range categories clip to the last ('misc') row, as the JAX encoder does
            emb = emb + table(torch.clamp(x_cat[..., i], 0, vocab - 1))
        if self.layers:
            emb = self.layers[0](torch.cat([emb, x_scalar], dim=-1))
        return emb


class GaussianSmearing(nn.Module):
    """Distance -> Gaussian RBF features on a linear grid."""

    def __init__(self, start: float = 0.0, stop: float = 5.0, num_gaussians: int = 50):
        super().__init__()
        self.start, self.stop, self.num = start, stop, num_gaussians
        self.coeff = -0.5 / float((stop - start) / (num_gaussians - 1)) ** 2

    def forward(self, dist):
        offset = torch.linspace(self.start, self.stop, self.num, dtype=dist.dtype, device=dist.device)
        return torch.exp(self.coeff * (dist[..., None] - offset) ** 2)


class BatchNormIrreps(nn.Module):
    """Irreps batch norm at inference (running statistics).

    Scalars (0e): (x - mean) / sqrt(var + eps) * weight + bias. Every other
    block (l > 0 and 0o): divided by sqrt(norm + eps), times weight.
    """

    def __init__(self, irreps, epsilon: float = 1e-5):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.epsilon = epsilon
        n_scalar = sum(mul for mul, ir in self.irreps if ir.l == 0 and ir.p == 1)
        n_field = sum(mul for mul, ir in self.irreps if not (ir.l == 0 and ir.p == 1))
        self.weight = nn.Parameter(torch.ones(self.irreps.num_irreps))
        self.bias = nn.Parameter(torch.zeros(n_scalar))
        self.register_buffer("mean", torch.zeros(n_scalar))
        self.register_buffer("var", torch.ones(n_scalar))
        self.register_buffer("norm", torch.ones(n_field))

    def forward(self, x):
        out = []
        i_s = i_f = i_w = 0
        for (mul, ir), sl in zip(self.irreps, self.irreps.slices()):
            blk = x[..., sl]
            w = self.weight[i_w : i_w + mul]
            i_w += mul
            if ir.l == 0 and ir.p == 1:
                mean, var, b = self.mean[i_s : i_s + mul], self.var[i_s : i_s + mul], self.bias[i_s : i_s + mul]
                i_s += mul
                out.append((blk - mean) / torch.sqrt(var + self.epsilon) * w + b)
            else:
                f = blk.reshape(blk.shape[:-1] + (mul, ir.dim))
                norm = self.norm[i_f : i_f + mul]
                i_f += mul
                out.append((f / torch.sqrt(norm + self.epsilon)[:, None] * w[:, None]).reshape(blk.shape))
        return torch.cat(out, dim=-1)


_SH2 = str(Irreps(SH2_IRREPS))


def pad_residual(x, out_dim: int):
    """Residual with zero padding to the wider irreps (the ladder only appends)."""
    return torch.nn.functional.pad(x, (0, out_dim - x.shape[-1]))


class TPConv(nn.Module):
    """Tensor-product convolution: edge MLP -> TP weights -> messages, then
    masked mean, batch norm and residual in ``finalize``.

    ``num_groups`` edge groups share the TP but have their own edge MLP."""

    def __init__(self, in_irreps: str, sh_irreps: str, out_irreps: str, n_edge_features: int, num_groups: int = 1,
                 hidden_features: Optional[int] = None, batch_norm: bool = True, residual: bool = True):
        super().__init__()
        self.in_irreps, self.sh_irreps, self.out_irreps = str(Irreps(in_irreps)), str(Irreps(sh_irreps)), str(Irreps(out_irreps))
        self.tp = WeightedTensorProduct(in_irreps, sh_irreps, out_irreps)
        hidden = hidden_features or n_edge_features
        self.edge_mlps = nn.ModuleList(FCBlock(n_edge_features, hidden, self.tp.weight_numel) for _ in range(num_groups))
        self.bn = BatchNormIrreps(out_irreps) if batch_norm else None
        self.residual = residual
        self.out_dim = Irreps(out_irreps).dim
        self._packed = {}  # (group, harmonics) -> (key of its parameters, PackedWeights, the parameters)
        self.lmax2 = self.sh_irreps == _SH2  # conv_rec takes the lmax=2 kernel

    def mlp_weights(self, group: int):
        """(w1 [in, H], b1, w2 [H, W], b2) of an edge group, in the [in, out]
        layout the kernels take (views of the nn.Linear parameters)."""
        l0, l1 = self.edge_mlps[group].layers
        return l0.weight.t(), l0.bias, l1.weight.t(), l1.bias

    def packed_weights(self, group: Optional[int], x) -> Optional[PackedWeights]:
        """An edge group's weights in the CUDA kernels' layout, made once and
        remade when a parameter moves or changes in place (``.to``,
        ``load_state_dict``); None for CPU tensors ``x`` or a None group."""
        if group is None or not x.is_cuda:
            return None
        weights = self.mlp_weights(group)
        key = tuple((w.data_ptr(), w._version) for w in weights)
        hit = self._packed.get((group, self.sh_irreps))
        if hit is None or hit[0] != key:
            # the entry holds the weights it was made from, so a replaced
            # parameter's storage is not freed and its address not reused
            packed = pack_weights(*weights, self.in_irreps, self.out_irreps, self.sh_irreps)
            hit = self._packed[(group, self.sh_irreps)] = (key, packed, weights)
        return hit[1]

    def messages(self, group: int, sender_attr, edge_sh, edge_attr, edge_mask):
        """Per-edge messages [..., out_dim]; masked edges are zero."""
        msg = self.tp(sender_attr, edge_sh, self.edge_mlps[group](edge_attr))
        return torch.where(edge_mask[..., None], msg, torch.zeros_like(msg))

    def conv_rec(self, group: int, node_attr, pos, nbr, edge_emb, sig, nbr_mask):
        """kNN messages of one node set (receptor <- receptor, atom <- atom):
        (sums [B, N, out], counts [B, N]); the rec kernel at lmax=1, rec_g
        at lmax=2."""
        counts = nbr_mask.sum(-1).to(torch.float32)
        args = (node_attr.contiguous(), pos.contiguous(), nbr.contiguous(), edge_emb.contiguous(), sig.contiguous(),
                nbr_mask.contiguous(), *self.mlp_weights(group))
        packed = self.packed_weights(group, node_attr)
        if self.lmax2:
            out = fused_tpconv_rec_g(*args, self.in_irreps, self.sh_irreps, self.out_irreps, edge_emb.shape[-1],
                                     packed=packed)
        else:
            out = fused_tpconv_rec(*args, self.in_irreps, self.out_irreps, edge_emb.shape[-1], packed=packed)
        return out, counts

    def conv_cross(self, group: int, recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, idx_mask, ns: int):
        """Messages of receivers over a capped list of senders from another
        node set at lmax=2 (ligand <- receptor, ligand <- atom; the cross_g
        kernel): (sums [B, L, out], counts [B, L])."""
        out = fused_tpconv_cross_g(recv_attr.contiguous(), recv_pos.contiguous(), src_attr.contiguous(),
                                   src_pos.contiguous(), idx.contiguous(), edge_emb.contiguous(), idx_mask.contiguous(),
                                   *self.mlp_weights(group), self.in_irreps, self.sh_irreps, self.out_irreps, ns,
                                   packed=self.packed_weights(group, recv_attr))
        return out, idx_mask.sum(-1).to(torch.float32)

    def conv_pb(self, group: int, lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask, ns: int):
        """Ligand <- ligand messages over dense pairs + bonds: (sums, counts)."""
        out = fused_tpconv_pb(lig_attr.contiguous(), lig_pos.contiguous(), pair_emb.contiguous(), pair_mask.contiguous(),
                              bond_src.contiguous(), bond_dst.contiguous(), bond_emb.contiguous(), bond_mask.contiguous(),
                              *self.mlp_weights(group), self.in_irreps, self.out_irreps, ns,
                              packed=self.packed_weights(group, lig_attr))
        counts = pair_mask.sum(-1).to(torch.float32) + scatter_count_to_nodes(bond_src, bond_mask, lig_attr.shape[1])
        return out, counts

    def conv_cross_rev(self, group_fwd: int, group_rev: Optional[int], recv_attr, recv_pos, src_attr, src_pos,
                       idx, edge_emb, idx_mask, ns: int):
        """Both directions of the cross edge list: (lig_sum, lig_counts,
        rec_sum, rec_counts); the receptor pair is None when group_rev is."""
        rw = self.mlp_weights(group_rev) if group_rev is not None else (None,) * 4
        lig_sum, rec_sum = fused_tpconv_cross_rev(
            recv_attr.contiguous(), recv_pos.contiguous(), src_attr.contiguous(), src_pos.contiguous(),
            idx.contiguous(), edge_emb.contiguous(), idx_mask.contiguous(), *self.mlp_weights(group_fwd), *rw,
            self.in_irreps, self.out_irreps, ns, packed_f=self.packed_weights(group_fwd, recv_attr),
            packed_r=self.packed_weights(group_rev, recv_attr),
        )
        lig_counts = idx_mask.sum(-1).to(torch.float32)
        rec_counts = None
        if rec_sum is not None:
            B = idx.shape[0]
            rec_counts = scatter_count_to_nodes(idx.reshape(B, -1), idx_mask.reshape(B, -1), src_attr.shape[1])
        return lig_sum, lig_counts, rec_sum, rec_counts

    def finalize(self, x_in, msg_sum, msg_count, node_mask):
        """Mean-aggregate, batch norm (padded nodes zeroed), residual."""
        out = msg_sum / torch.clamp(msg_count, min=1.0)[..., None]
        if self.bn is not None:
            out = self.bn(out)
            out = torch.where(node_mask[..., None], out, torch.zeros_like(out))
        if self.residual:
            out = out + pad_residual(x_in, self.out_dim)
        return out
