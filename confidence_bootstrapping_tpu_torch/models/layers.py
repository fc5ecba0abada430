"""Building blocks of the equivariant score model.

Port of ``confidence_bootstrapping_tpu/models/layers.py``: ``FCBlock``,
``AtomEncoder``, ``GaussianSmearing``, ``BatchNormIrreps``, ``LinearIrreps``
and ``TPConv``. ``TPConv``'s convolutions go through the CUDA kernels of
``ops/cuda`` for CUDA tensors and through their plain PyTorch versions for
CPU tensors, on the route the layer takes (``TPConv.route``, the JAX
package's ``_fused_mode``): the ladder kernels (rec, pb, cross_rev, row 4
and the edge-list kernel's rows 5-6) for lmax=1 harmonics on the irreps
ladder; the general kernels (``rec_g``, ``cross_g``, the edge-list kernel)
for every other layout they take at lmax 1 or 2, the confidence model's
lmax=2 and the second-order ladder's l = 2 node blocks among them; the
edge-list kernel alone at sh_lmax=3, where the JAX package gathers the kNN
and cross senders first; none (plain PyTorch) for depthwise layers and edge
MLPs of other than 2 layers.

On the ladder route the JAX package's gates are kept: ``conv_pb`` (the ligand pairs and bonds in one kernel) applies
only when L % 8 == 0, ``conv_cross_rev`` (both cross directions) only when
the cross list's K % 16 == 0, and ``conv_rec``'s kernel only when
N % 32 == 0. ``conv_pb`` and ``conv_cross_rev`` return None otherwise and the
caller composes the same function from ``conv_nbr`` (the edge-list sums),
``conv_cross`` (ligand <- receptor sums), ``msgs_nbr`` (per-edge messages)
and a scatter; ``conv_rec`` gathers its senders and calls ``conv_nbr``
itself. The kernels themselves take any N, L and K.

Training (``deterministic=False``) follows the JAX package's training
routing: every TP-conv goes through the differentiable ops of
``ops/cuda/tpconv_train.py`` (the receptor kNN groups through
``fused_tpconv_rec_train``, every other group through ``fused_tpconv_train``)
with a hidden-layer dropout mask drawn once per call; dropout masks come from
the generator the caller passes. ``use_running_average=False`` normalizes with
the batch's masked statistics and updates the running ones. Inside
``parallel.mesh.data_parallel`` the statistics are those of the global
batch's valid rows (counts and sums over the ranks, differentiable) and the
dropout masks are drawn at the global batch's rows, so a rank's slice
computes what the one-process run computes for those rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cuda.tpconv_common import SH_IRREPS, PackedWeights, gather_harmonics, general_route, is_ladder, \
    pack_weights, takes_harmonics
from ..ops.cuda.tpconv_edge import edge_build, fused_tpconv_edge
from ..ops.cuda.tpconv_g import fused_tpconv_cross_g, fused_tpconv_rec_g
from ..ops.cuda.tpconv_lig import fused_tpconv_cross_rev, fused_tpconv_pb
from ..ops.cuda.tpconv_rec import fused_tpconv_cross, fused_tpconv_rec
from ..ops.cuda.tpconv_train import fused_tpconv_rec_train, fused_tpconv_train
from ..ops.cuda.tpconv_v3 import fused_tpconv_msgs, fused_tpconv_nbr
from ..ops.graph_builders import gather_nodes, scatter_count_to_nodes
from ..parallel.mesh import all_sum, psum, rows
from ..ops.irreps import DepthwiseTensorProduct, Irreps, WeightedTensorProduct, linear_apply, linear_weight_shapes, \
    spherical_harmonics


def dropout_mask(shape, p: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """nn.Dropout's mask: 1/keep with probability keep = 1 - p, else 0
    (float32, drawn from ``generator``)."""
    keep = 1.0 - p
    return (rows(torch.rand, shape, generator, device) < keep).to(torch.float32) / keep


def dropout(x, p: float, deterministic: bool, generator: Optional[torch.Generator]):
    if deterministic or p <= 0.0:
        return x
    return x * dropout_mask(x.shape, p, generator, x.device)


class FCBlock(nn.Module):
    """Linear (ReLU Dropout Linear) * (depth - 1)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, depth: int = 2, dropout: float = 0.0):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (depth - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dropout = dropout

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        for i, lin in enumerate(self.layers):
            if i:
                x = dropout(torch.relu(x), self.dropout, deterministic, generator)
            x = lin(x)
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
    """Masked irreps batch norm (e3nn's semantics, the JAX package's).

    Scalars (0e): (x - mean) / sqrt(var + eps) * weight + bias. Every other
    block (l > 0 and 0o): divided by sqrt(norm + eps), times weight, where
    norm is the mean square over the block's components. With
    ``use_running_average`` the running statistics; otherwise the masked
    statistics of the batch's valid rows (biased variance), which the running
    ones then move toward with ``momentum``.
    """

    def __init__(self, irreps, epsilon: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.epsilon = epsilon
        self.momentum = momentum
        n_scalar = sum(mul for mul, ir in self.irreps if ir.l == 0 and ir.p == 1)
        n_field = sum(mul for mul, ir in self.irreps if not (ir.l == 0 and ir.p == 1))
        self.weight = nn.Parameter(torch.ones(self.irreps.num_irreps))
        self.bias = nn.Parameter(torch.zeros(n_scalar))
        self.register_buffer("mean", torch.zeros(n_scalar))
        self.register_buffer("var", torch.ones(n_scalar))
        self.register_buffer("norm", torch.ones(n_field))

    def forward(self, x, mask=None, use_running_average: bool = True):
        if not use_running_average:
            m = (torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device) if mask is None else mask).to(x.dtype)
            denom = torch.clamp(psum(m.sum()), min=1.0)
            axes = tuple(range(x.ndim - 1))
        out, new_means, new_vars, new_norms = [], [], [], []
        i_s = i_f = i_w = 0
        for (mul, ir), sl in zip(self.irreps, self.irreps.slices()):
            blk = x[..., sl]
            w = self.weight[i_w : i_w + mul]
            i_w += mul
            if ir.l == 0 and ir.p == 1:
                if use_running_average:
                    mean, var = self.mean[i_s : i_s + mul], self.var[i_s : i_s + mul]
                else:
                    mean = all_sum(torch.sum(blk * m[..., None], dim=axes)) / denom
                    var = all_sum(torch.sum((blk - mean) ** 2 * m[..., None], dim=axes)) / denom
                    new_means.append(mean)
                    new_vars.append(var)
                b = self.bias[i_s : i_s + mul]
                i_s += mul
                out.append((blk - mean) / torch.sqrt(var + self.epsilon) * w + b)
            else:
                f = blk.reshape(blk.shape[:-1] + (mul, ir.dim))
                if use_running_average:
                    norm = self.norm[i_f : i_f + mul]
                else:
                    norm = all_sum(torch.sum(torch.mean(f**2, dim=-1) * m[..., None], dim=axes)) / denom
                    new_norms.append(norm)
                i_f += mul
                out.append((f / torch.sqrt(norm + self.epsilon)[:, None] * w[:, None]).reshape(blk.shape))
        if not use_running_average:
            with torch.no_grad():
                mom = self.momentum
                for buf, new in ((self.mean, new_means), (self.var, new_vars), (self.norm, new_norms)):
                    if new:
                        buf.mul_(1 - mom).add_(mom * torch.cat(new).detach())
        return torch.cat(out, dim=-1)


class LinearIrreps(nn.Module):
    """Equivariant linear map (``ops.irreps.linear_apply``): weights
    ``w_{ii}_{oi}`` [mul_in, mul_out] per pair of blocks of one irrep type,
    biases ``b_{oi}`` on the scalar outputs, parameters of those names (the
    JAX package's)."""

    def __init__(self, irreps_in: str, irreps_out: str):
        super().__init__()
        self.irreps_in, self.irreps_out = str(Irreps(irreps_in)), str(Irreps(irreps_out))
        self.weight_names = []
        for k, shape in linear_weight_shapes(irreps_in, irreps_out):
            self.register_parameter(k, nn.Parameter(torch.zeros(shape)))
            self.weight_names.append(k)
        self.bias_names = []
        for oi, (mo, ir) in enumerate(Irreps(irreps_out)):
            if ir.l == 0:
                self.register_parameter(f"b_{oi}", nn.Parameter(torch.zeros(mo)))
                self.bias_names.append(f"b_{oi}")

    def forward(self, x):
        return linear_apply(self.irreps_in, self.irreps_out, x, {k: getattr(self, k) for k in self.weight_names},
                            {k: getattr(self, k) for k in self.bias_names})


_SH1 = str(Irreps(SH_IRREPS))


def pad_residual(x, out_dim: int):
    """Residual with zero padding to the wider irreps (the ladder only appends)."""
    return torch.nn.functional.pad(x, (0, out_dim - x.shape[-1]))


class TPConv(nn.Module):
    """Tensor-product convolution: edge MLP -> TP weights -> messages, then
    masked mean, batch norm and residual in ``finalize``.

    ``num_groups`` edge groups share the TP but have their own edge MLP
    (``tp_weights_layers`` layers). ``route``, fixed when the layer is built
    as the JAX package's ``TPConv._fused_mode`` chooses it: "ladder" (lmax=1
    harmonics and the lmax=1 irreps ladder: the rec, pb, cross_rev, row 4 and
    edge-list kernels), "general" (any other layout the kernels take at
    lmax 1 or 2, ``tpconv_common.general_route``: rec_g, cross_g and the
    edge-list kernel), "edge" (the layouts at sh_lmax=3, where the JAX
    package gathers the kNN and cross senders first: the edge-list kernel,
    in training the differentiable edge-list op, and never the kernels that
    gather their senders), or None: plain PyTorch in every mode, for
    ``depthwise`` layers (a per-channel TP whose messages a linear map mixes
    after the mean, ``finalize``), edge MLPs of other than 2 layers and
    layouts no kernel takes.
    ``edge_kernel``: ``messages`` at inference runs the edge-list kernel
    (the legacy models' layers). The modern models keep the JAX package's
    plain TP for their per-edge calls at inference (bonds, center and
    torsion convolutions), the routing that the launch counts of their
    kernels follow. A layer whose harmonics no kernel takes
    (``kernel_harmonics`` false: the torsion head's at lmax=2, up to l=4)
    computes its messages in plain PyTorch in every mode."""

    def __init__(self, in_irreps: str, sh_irreps: str, out_irreps: str, n_edge_features: int, num_groups: int = 1,
                 hidden_features: Optional[int] = None, batch_norm: bool = True, residual: bool = True,
                 dropout: float = 0.0, edge_kernel: bool = False, tp_weights_layers: int = 2, depthwise: bool = False):
        super().__init__()
        self.n_edge_features = n_edge_features
        self.in_irreps, self.sh_irreps, self.out_irreps = str(Irreps(in_irreps)), str(Irreps(sh_irreps)), str(Irreps(out_irreps))
        self.depthwise = depthwise
        if depthwise:
            self.tp = DepthwiseTensorProduct(in_irreps, sh_irreps)
            self.linear_2 = LinearIrreps(str(self.tp.irreps_out), out_irreps)
        else:
            self.tp = WeightedTensorProduct(in_irreps, sh_irreps, out_irreps)
        if depthwise or tp_weights_layers != 2 or not general_route(self.in_irreps, self.sh_irreps, self.out_irreps):
            self.route = None
        elif self.sh_irreps == _SH1 and is_ladder(self.in_irreps, self.out_irreps):
            self.route = "ladder"
        elif gather_harmonics(self.sh_irreps):
            self.route = "general"
        else:
            self.route = "edge"
        self.kernel_harmonics = takes_harmonics(self.sh_irreps) and self.route is not None
        self.edge_kernel = edge_kernel and self.kernel_harmonics
        hidden = hidden_features or n_edge_features
        self.hidden = hidden
        self.dropout = dropout  # the edge MLPs' hidden layers, in training
        self.edge_mlps = nn.ModuleList(FCBlock(n_edge_features, hidden, self.tp.weight_numel, tp_weights_layers, dropout)
                                       for _ in range(num_groups))
        self.bn = BatchNormIrreps(out_irreps) if batch_norm else None
        self.residual = residual
        self.out_dim = Irreps(out_irreps).dim
        self._packed = {}  # (group, harmonics) -> (key of its parameters, PackedWeights, the parameters)
        self.ladder = self.route == "ladder"

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

    def _dmask(self, lead, generator, device):
        """The hidden-layer dropout mask of one training call, lead + (H,);
        None without dropout."""
        return dropout_mask(tuple(lead) + (self.hidden,), self.dropout, generator, device) if self.dropout > 0 else None

    def _edge_list(self, group: int, sender_attr, edge_sh, edge_attr, edge_mask, sum_k: bool, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """An edge-list op over [..., K, *] edge tensors, broadcast to one
        shape and flattened to contiguous [M, K, *]: in training the
        differentiable op (dropout drawn from ``generator``), at inference
        the edge-list kernel (on the ladder route ``fused_tpconv_nbr`` for
        sums, ``fused_tpconv_msgs`` per edge; otherwise
        ``fused_tpconv_edge``). -> [..., out_dim] (sum_k) or
        [..., K, out_dim]."""
        lead = torch.broadcast_shapes(sender_attr.shape[:-1], edge_sh.shape[:-1], edge_attr.shape[:-1], edge_mask.shape)
        K = lead[-1]
        flat = lambda a: a.expand(lead + a.shape[-1:]).reshape(-1, K, a.shape[-1]).contiguous()
        mask = edge_mask.expand(lead).reshape(-1, K).contiguous()
        args = (flat(edge_attr), flat(sender_attr), flat(edge_sh), mask, *self.mlp_weights(group))
        packed = self.packed_weights(group, edge_attr)
        if train:
            out = fused_tpconv_train(*args, self.in_irreps, self.sh_irreps, self.out_irreps,
                                     dmask=self._dmask(mask.shape, generator, mask.device), sum_k=sum_k, packed=packed)
        elif self.ladder:
            out = (fused_tpconv_nbr if sum_k else fused_tpconv_msgs)(*args, self.in_irreps, self.out_irreps,
                                                                      packed=packed)
        else:
            out = fused_tpconv_edge(*args, self.in_irreps, self.sh_irreps, self.out_irreps, sum_k=sum_k, packed=packed)
        return out.reshape((lead[:-1] if sum_k else lead) + (out.shape[-1],))

    def edge_build(self, K: int) -> tuple:
        """(tensor cores?, edges a chunk): the build of the edge-list kernel
        that a launch of this layer takes for lists of K edges
        (``tpconv_edge.edge_build``; raises where none fits)."""
        return edge_build(self.in_irreps, self.sh_irreps, self.out_irreps, self.n_edge_features, self.hidden, K)

    def messages(self, group: int, sender_attr, edge_sh, edge_attr, edge_mask, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None, edge_weight=None):
        """Per-edge messages [..., out_dim]; masked edges are zero. In
        training the differentiable edge-list op; at inference the plain TP,
        or with ``edge_kernel`` the edge-list kernel; on no kernel route
        (``kernel_harmonics`` false) the plain composition in both, the edge
        MLP's dropout drawn per hidden layer (``FCBlock``). ``edge_weight`` [...] (the
        legacy models' smooth edges) scales each edge's TP weights, so it
        multiplies the message (the TP is linear in its weights)."""
        if self.kernel_harmonics and (not deterministic or self.edge_kernel):
            msg = self._edge_list(group, sender_attr, edge_sh, edge_attr, edge_mask, False, not deterministic,
                                  generator)
        else:
            msg = self.tp(sender_attr, edge_sh, self.edge_mlps[group](edge_attr, deterministic, generator))
            msg = torch.where(edge_mask[..., None], msg, torch.zeros_like(msg))
        return msg if edge_weight is None else msg * edge_weight[..., None]

    def conv_nbr(self, group: int, sender_attr, edge_sh, edge_attr, edge_mask, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None):
        """Messages summed over the trailing neighbour axis: [..., K, *] ->
        (sums [..., out_dim], counts [...]). On a kernel route the edge-list
        kernel at inference (``fused_tpconv_nbr`` on the ladder route) and
        the differentiable edge-list op in training; otherwise ``messages``."""
        counts = edge_mask.sum(-1).to(torch.float32)
        if self.route is not None:
            return self._edge_list(group, sender_attr, edge_sh, edge_attr, edge_mask, True, not deterministic,
                                   generator), counts
        return self.messages(group, sender_attr, edge_sh, edge_attr, edge_mask, deterministic, generator).sum(-2), counts

    def msgs_nbr(self, group: int, sender_attr, edge_sh, edge_attr, edge_mask, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None):
        """Per-edge messages over a neighbour list [..., K, *] -> [..., K,
        out_dim], masked edges exactly zero, for groups that scatter to other
        nodes afterwards (the receptor <- ligand cross lists). At inference
        on a kernel route the edge-list kernel (``fused_tpconv_msgs`` on the
        ladder route); otherwise ``messages``."""
        if deterministic and self.route is not None:
            return self._edge_list(group, sender_attr, edge_sh, edge_attr, edge_mask, False)
        return self.messages(group, sender_attr, edge_sh, edge_attr, edge_mask, deterministic, generator)

    def _gathered(self, node_attr, node_pos, recv_attr, recv_pos, idx, edge_emb, ns: int):
        """Senders, harmonics and MLP inputs [emb | recv scalars | send
        scalars] of a neighbour list gathered from a node table."""
        sender = gather_nodes(node_attr, idx)
        sh = spherical_harmonics(Irreps(self.sh_irreps)[-1].ir.l, gather_nodes(node_pos, idx) - recv_pos[:, :, None, :])
        eattr = torch.cat([edge_emb, recv_attr[:, :, None, :ns].expand(sender.shape[:-1] + (ns,)), sender[..., :ns]],
                          dim=-1)
        return sender, sh, eattr

    def conv_rec(self, group: int, node_attr, pos, nbr, edge_emb, sig, nbr_mask, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None):
        """kNN messages of one node set (receptor <- receptor, atom <- atom):
        (sums [B, N, out], counts [B, N]). On the ladder route the rec kernel
        when N % 32 == 0 (otherwise the senders gathered, then ``conv_nbr``,
        as the JAX package routes it), on the general route rec_g; in
        training, on either route, the differentiable
        ``fused_tpconv_rec_train`` with the hidden-layer dropout mask; on the
        "edge" route and on no kernel route the gathered senders through
        ``conv_nbr``."""
        counts = nbr_mask.sum(-1).to(torch.float32)
        if self.route in (None, "edge") or (deterministic and self.ladder and node_attr.shape[1] % 32):
            sender, sh, eattr = self._gathered(node_attr, pos, node_attr, pos, nbr, edge_emb + sig[:, None, None, :],
                                               edge_emb.shape[-1])
            return self.conv_nbr(group, sender, sh, eattr, nbr_mask, deterministic, generator)[0], counts
        args = (node_attr.contiguous(), pos.contiguous(), nbr.contiguous(), edge_emb.contiguous(), sig.contiguous(),
                nbr_mask.contiguous(), *self.mlp_weights(group))
        packed = self.packed_weights(group, node_attr)
        if not deterministic:
            out = fused_tpconv_rec_train(*args, self.in_irreps, self.sh_irreps, self.out_irreps, edge_emb.shape[-1],
                                         dmask=self._dmask(nbr.shape, generator, nbr.device), packed=packed)
        elif self.ladder:
            out = fused_tpconv_rec(*args, self.in_irreps, self.out_irreps, edge_emb.shape[-1], packed=packed)
        else:
            out = fused_tpconv_rec_g(*args, self.in_irreps, self.sh_irreps, self.out_irreps, edge_emb.shape[-1],
                                     packed=packed)
        return out, counts

    def conv_cross(self, group: int, recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, idx_mask, ns: int,
                   deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """Messages of receivers over a capped list of senders from another
        node set (ligand <- receptor, ligand <- atom): (sums [B, L, out],
        counts [B, L]). At inference the cross kernel of the route
        (``fused_tpconv_cross`` on the ladder route, ``fused_tpconv_cross_g``
        on the general one); in training, on the "edge" route and on no
        kernel route, the JAX package's fallback: the senders gathered, then
        ``conv_nbr``."""
        if not deterministic or self.route in (None, "edge"):
            sender, sh, eattr = self._gathered(src_attr, src_pos, recv_attr, recv_pos, idx, edge_emb, ns)
            return self.conv_nbr(group, sender, sh, eattr, idx_mask, deterministic, generator)
        args = (recv_attr.contiguous(), recv_pos.contiguous(), src_attr.contiguous(), src_pos.contiguous(),
                idx.contiguous(), edge_emb.contiguous(), idx_mask.contiguous(), *self.mlp_weights(group))
        packed = self.packed_weights(group, recv_attr)
        if self.ladder:
            out = fused_tpconv_cross(*args, self.in_irreps, self.out_irreps, ns, packed=packed)
        else:
            out = fused_tpconv_cross_g(*args, self.in_irreps, self.sh_irreps, self.out_irreps, ns, packed=packed)
        return out, idx_mask.sum(-1).to(torch.float32)

    def conv_pb(self, group: int, lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask, ns: int):
        """Ligand <- ligand messages over dense pairs + bonds: (sums, counts),
        or None off the ladder route or when L % 8 != 0 (the caller composes
        the pairs through ``conv_nbr`` and the bonds through ``messages``)."""
        if not self.ladder or lig_attr.shape[1] % 8:
            return None
        out = fused_tpconv_pb(lig_attr.contiguous(), lig_pos.contiguous(), pair_emb.contiguous(), pair_mask.contiguous(),
                              bond_src.contiguous(), bond_dst.contiguous(), bond_emb.contiguous(), bond_mask.contiguous(),
                              *self.mlp_weights(group), self.in_irreps, self.out_irreps, ns,
                              packed=self.packed_weights(group, lig_attr))
        counts = pair_mask.sum(-1).to(torch.float32) + scatter_count_to_nodes(bond_src, bond_mask, lig_attr.shape[1])
        return out, counts

    def conv_cross_rev(self, group_fwd: int, group_rev: Optional[int], recv_attr, recv_pos, src_attr, src_pos,
                       idx, edge_emb, idx_mask, ns: int):
        """Both directions of the cross edge list: (lig_sum, lig_counts,
        rec_sum, rec_counts); the receptor pair is None when group_rev is.
        None off the ladder route or when the list's K % 16 != 0 (the caller
        composes ``conv_cross``, ``msgs_nbr`` and a scatter)."""
        if not self.ladder or idx.shape[-1] % 16:
            return None
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

    def finalize(self, x_in, msg_sum, msg_count, node_mask, use_running_average: bool = True):
        """Mean-aggregate, (depthwise: the linear map), batch norm (padded
        nodes zeroed; batch statistics over the valid nodes unless
        ``use_running_average``), residual."""
        out = msg_sum / torch.clamp(msg_count, min=1.0)[..., None]
        if self.depthwise:
            out = self.linear_2(out)
        if self.bn is not None:
            out = self.bn(out, node_mask, use_running_average)
            out = torch.where(node_mask[..., None], out, torch.zeros_like(out))
        if self.residual:
            out = out + pad_residual(x_in, self.out_dim)
        return out
