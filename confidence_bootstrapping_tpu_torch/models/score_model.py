"""SE(3)-equivariant tensor-product score model on padded complex batches.

Port of ``confidence_bootstrapping_tpu/models/score_model.py`` in score mode:
atom encoders, receptor and ligand embedding convolutions, the 4-edge-group
trunk whose last layer updates the ligand only, the center convolution with
the translation and rotation heads, and the torsion head. Ligand radius
pairs are a dense masked [L, L] adjacency, cross edges are the nearest
``effective_cross_cap(N)`` receptor residues within 3 sigma_tr + 20,
receptor kNN lists come with the batch. The t-independent receptor embedding
is separate (``embed_receptor``) so the sampler computes it once.

``ConfidenceHead`` and ``MaskedBatchNorm1d`` (running statistics) serve the
all-atom confidence model (``models/all_atom_model.py``). Confidence mode of
this residue-level model and ``torsional_forward`` are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import ScoreModelConfig
from ..data.complex_graph import ComplexBatch
from ..data.vocab import LIG_FEATURE_DIMS, REC_RESIDUE_FEATURE_DIMS
from ..ops import so3, torus
from ..ops.graph_builders import gather_nodes, radius_mask, topk_neighbors
from ..ops.irreps import FullTensorProduct, Irreps, spherical_harmonics, spherical_harmonics_irreps
from ..ops.schedules import get_timestep_embedding, t_to_sigma
from ..runtime import resolve_device
from .layers import AtomEncoder, FCBlock, GaussianSmearing, TPConv


def get_irrep_seq(ns: int, nv: int, reduce_pseudoscalars: bool):
    """The lmax=1 irreps ladder."""
    last = nv if reduce_pseudoscalars else ns
    return [f"{ns}x0e", f"{ns}x0e + {nv}x1o", f"{ns}x0e + {nv}x1o + {nv}x1e", f"{ns}x0e + {nv}x1o + {nv}x1e + {last}x0o"]


class RecCache(NamedTuple):
    """t-independent receptor tensors, computed once per complex."""

    rec_attr: torch.Tensor  # [B, N, D] embedded receptor node features
    rec_edge_emb: torch.Tensor  # [B, N, KR, ns] embedded kNN edge features
    rec_edge_mask: torch.Tensor  # [B, N, KR]


class ScoreOutput(NamedTuple):
    tr_pred: torch.Tensor  # [B, 3]
    rot_pred: torch.Tensor  # [B, 3]
    tor_pred: torch.Tensor  # [B, R], zero on padded torsion slots


class FinalNormMLP(nn.Module):
    """MLP rescaling the tr/rot vector norm: Linear ReLU Linear."""

    def __init__(self, in_dim: int, ns: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns), nn.Linear(ns, 1)])

    def forward(self, norm, sigma_emb):
        return self.layers[1](torch.relu(self.layers[0](torch.cat([norm, sigma_emb], dim=-1))))


class TorFinalMLP(nn.Module):
    """Bias-free tanh MLP for the torsion logits."""

    def __init__(self, in_dim: int, ns: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns, bias=False), nn.Linear(ns, 1, bias=False)])

    def forward(self, x):
        return self.layers[1](torch.tanh(self.layers[0](x)))


class TensorProductScoreModel(nn.Module):
    """Score model; built on ``device`` (default: the GPU) with weights drawn
    from ``seed``. Load trained weights with ``models.from_flax``."""

    def __init__(self, cfg: ScoreModelConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.sh_lmax != 1:
            raise NotImplementedError("the port's TP-conv kernels take lmax=1 harmonics")
        self.cfg = c = cfg
        ns, nv = c.ns, c.nv
        sh = str(spherical_harmonics_irreps(c.sh_lmax))
        self.timestep_emb = get_timestep_embedding(c.embedding_type, c.sigma_embed_dim, c.embedding_scale)
        sig = c.sigma_embed_dim

        self.lig_node_embedding = AtomEncoder(ns, LIG_FEATURE_DIMS, n_scalar=sig)
        self.lig_edge_embedding = FCBlock(c.in_lig_edge_features + sig + c.distance_embed_dim, ns, ns)
        self.rec_node_embedding = AtomEncoder(ns, REC_RESIDUE_FEATURE_DIMS, n_scalar=c.lm_embedding_dim)
        self.rec_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns)
        self.rec_sigma_embedding = FCBlock(sig, ns, ns)
        self.cross_edge_embedding = FCBlock(sig + c.cross_distance_embed_dim, ns, ns)
        self.lig_distance_expansion = GaussianSmearing(0.0, c.lig_max_radius, c.distance_embed_dim)
        self.rec_distance_expansion = GaussianSmearing(0.0, c.rec_max_radius, c.distance_embed_dim)
        self.cross_distance_expansion = GaussianSmearing(0.0, c.cross_max_distance, c.cross_distance_embed_dim)

        seq = get_irrep_seq(ns, nv, c.reduce_pseudoscalars)
        P, C = c.num_prot_emb_layers, c.num_conv_layers

        def conv(i, groups):
            return TPConv(seq[min(i, 3)], sh, seq[min(i + 1, 3)], 3 * ns, num_groups=groups,
                          hidden_features=3 * ns, batch_norm=c.batch_norm, residual=True)

        self.rec_emb_layers = nn.ModuleList(conv(i, 1) for i in range(P))
        self.lig_emb_layers = nn.ModuleList(conv(i, 1) for i in range(P))
        self.conv_layers = nn.ModuleList(
            conv(i, ((2 if i == P + C - 1 else 4) if c.differentiate_convolutions else 1)) for i in range(P, P + C)
        )
        self.final_irreps = seq[min(P + C, 3)]

        self.center_distance_expansion = GaussianSmearing(0.0, c.center_max_distance, c.distance_embed_dim)
        self.center_edge_embedding = FCBlock(c.distance_embed_dim + sig, ns, ns)
        self.final_conv = TPConv(self.final_irreps, sh, "2x1o + 2x1e" if not c.odd_parity else "1x1o + 1x1e",
                                 2 * ns, batch_norm=c.batch_norm, residual=False)
        self.tr_final_layer = FinalNormMLP(1 + sig, ns)
        self.rot_final_layer = FinalNormMLP(1 + sig, ns)
        if not c.no_torsion:
            self.final_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns)
            self.final_tp_tor = FullTensorProduct(sh, "1x2e")
            tor_out = f"{ns}x0o + {ns}x0e" if not c.odd_parity else f"{ns}x0o"
            self.tor_bond_conv = TPConv(self.final_irreps, str(self.final_tp_tor.irreps_out), tor_out, 3 * ns,
                                        batch_norm=c.batch_norm, residual=False)
            self.tor_final_layer = TorFinalMLP(Irreps(tor_out).dim, ns)

        init_weights(self, seed)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    # ------------------------------------------------------------------ #
    # receptor embedding (t-independent)
    # ------------------------------------------------------------------ #

    def embed_receptor(self, batch: ComplexBatch) -> RecCache:
        c = self.cfg
        rec_attr = self.rec_node_embedding(batch.rec_f[..., None], batch.rec_lm)
        vec = gather_nodes(batch.rec_pos, batch.rec_nbr) - batch.rec_pos[:, :, None, :]
        edge_emb = self.rec_edge_embedding(self.rec_distance_expansion(torch.linalg.norm(vec, dim=-1)))
        emask = batch.rec_nbr_mask
        zero_sig = torch.zeros(rec_attr.shape[0], c.ns, dtype=rec_attr.dtype, device=rec_attr.device)
        for layer in self.rec_emb_layers:
            s, cnt = layer.conv_rec(0, rec_attr, batch.rec_pos, batch.rec_nbr, edge_emb, zero_sig, emask)
            rec_attr = layer.finalize(rec_attr, s, cnt, batch.rec_mask)
        return RecCache(rec_attr=rec_attr, rec_edge_emb=edge_emb, rec_edge_mask=emask)

    # ------------------------------------------------------------------ #
    # ligand graph
    # ------------------------------------------------------------------ #

    def _lig_graph(self, batch: ComplexBatch, sigma_emb):
        """Embedded dense radius pairs (receiver i, sender j) and bond edges."""
        c = self.cfg
        pos = batch.lig_pos
        pair_mask, pair_d = radius_mask(pos, pos, c.lig_max_radius, batch.lig_mask, batch.lig_mask, exclude_self=True)
        zeros_bond = pair_d.new_zeros(pair_d.shape + (c.in_lig_edge_features,))
        se = sigma_emb[:, None, None, :].expand(pair_d.shape + (sigma_emb.shape[-1],))
        pair_emb = self.lig_edge_embedding(torch.cat([zeros_bond, se, self.lig_distance_expansion(pair_d)], dim=-1))
        bvec = gather_nodes(pos, batch.lig_edge_dst) - gather_nodes(pos, batch.lig_edge_src)
        bd = torch.linalg.norm(bvec, dim=-1)
        se_b = sigma_emb[:, None, :].expand(bd.shape + (sigma_emb.shape[-1],))
        bond_emb = self.lig_edge_embedding(torch.cat([batch.lig_edge_attr, se_b, self.lig_distance_expansion(bd)], dim=-1))
        return pair_mask, pair_emb, bond_emb

    def _lig_conv(self, layer: TPConv, group: int, lig_attr, graph, batch: ComplexBatch):
        pair_mask, pair_emb, bond_emb = graph
        return layer.conv_pb(group, lig_attr, batch.lig_pos, pair_emb, pair_mask, batch.lig_edge_src,
                             batch.lig_edge_dst, bond_emb, batch.lig_edge_mask, self.cfg.ns)

    # ------------------------------------------------------------------ #
    # forward
    # ------------------------------------------------------------------ #

    def forward(self, batch: ComplexBatch, rec_cache: Optional[RecCache] = None) -> ScoreOutput:
        c = self.cfg
        ns = c.ns
        B, L, _ = batch.lig_pos.shape
        N = batch.rec_pos.shape[1]
        tr_sigma, rot_sigma, tor_sigma = t_to_sigma(batch.t_tr, batch.t_rot, batch.t_tor, c.sigma)
        sigma_emb = self.timestep_emb(batch.t_tr)

        if rec_cache is None:
            rec_cache = self.embed_receptor(batch)
        rec_sig = self.rec_sigma_embedding(sigma_emb)
        rec_attr = rec_cache.rec_attr
        rec_attr = torch.cat([rec_attr[..., :ns] + rec_sig[:, None, :], rec_attr[..., ns:]], dim=-1)

        lig_attr = self.lig_node_embedding(batch.lig_f, sigma_emb[:, None, :].expand(B, L, sigma_emb.shape[-1]))
        graph = self._lig_graph(batch, sigma_emb)
        for layer in self.lig_emb_layers:
            s, n = self._lig_conv(layer, 0, lig_attr, graph, batch)
            lig_attr = layer.finalize(lig_attr, s, n, batch.lig_mask)

        cutoff = (tr_sigma * 3 + 20)[:, None, None] if c.dynamic_max_cross else c.cross_max_distance
        cr_idx, cr_mask, cr_d = topk_neighbors(batch.lig_pos, batch.rec_pos, cutoff, batch.lig_mask, batch.rec_mask,
                                               c.effective_cross_cap(N))
        se_c = sigma_emb[:, None, None, :].expand(cr_d.shape + (sigma_emb.shape[-1],))
        cr_emb = self.cross_edge_embedding(torch.cat([se_c, self.cross_distance_expansion(cr_d)], dim=-1))

        n_layers = len(self.conv_layers)
        for li, layer in enumerate(self.conv_layers):
            last = li == n_layers - 1
            if c.differentiate_convolutions:
                g_lig, g_lr, g_rec, g_rl = 0, 1, (None if last else 2), (None if last else 3)
            else:
                g_lig = g_lr = g_rec = 0
                g_rl = None if last else 0
            lig_sum, lig_cnt = self._lig_conv(layer, g_lig, lig_attr, graph, batch)
            s_lr, c_lr, s_rl, c_rl = layer.conv_cross_rev(g_lr, g_rl, lig_attr, batch.lig_pos, rec_attr,
                                                          batch.rec_pos, cr_idx, cr_emb, cr_mask, ns)
            lig_sum, lig_cnt = lig_sum + s_lr, lig_cnt + c_lr
            if not last:
                rec_sum, rec_cnt = layer.conv_rec(g_rec, rec_attr, batch.rec_pos, batch.rec_nbr,
                                                  rec_cache.rec_edge_emb, rec_sig, rec_cache.rec_edge_mask)
                new_lig = layer.finalize(lig_attr, lig_sum, lig_cnt, batch.lig_mask)
                rec_attr = layer.finalize(rec_attr, rec_sum + s_rl, rec_cnt + c_rl, batch.rec_mask)
                lig_attr = new_lig
            else:
                lig_attr = layer.finalize(lig_attr, lig_sum, lig_cnt, batch.lig_mask)

        # center convolution: translational / rotational pseudo-vectors
        m = batch.lig_mask.to(lig_attr.dtype)[..., None]
        center = torch.sum(batch.lig_pos * m, dim=1, keepdim=True) / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
        cvec = batch.lig_pos - center
        cd = torch.linalg.norm(cvec, dim=-1)
        csh = spherical_harmonics(c.sh_lmax, cvec)
        se_l = sigma_emb[:, None, :].expand(cd.shape + (sigma_emb.shape[-1],))
        cattr = self.center_edge_embedding(torch.cat([self.center_distance_expansion(cd), se_l], dim=-1))
        cattr = torch.cat([cattr, lig_attr[..., :ns]], dim=-1)
        msg_c = self.final_conv.messages(0, lig_attr, csh, cattr, batch.lig_mask)
        cnt_c = torch.sum(batch.lig_mask, dim=1).to(msg_c.dtype)
        global_pred = self.final_conv.finalize(None, msg_c.sum(dim=1), cnt_c,
                                               torch.ones(B, dtype=torch.bool, device=msg_c.device))
        if c.odd_parity:
            tr_pred, rot_pred = global_pred[:, :3], global_pred[:, 3:6]
        else:
            tr_pred = global_pred[:, :3] + global_pred[:, 6:9]
            rot_pred = global_pred[:, 3:6] + global_pred[:, 9:12]
        tr_norm = torch.linalg.norm(tr_pred, dim=1, keepdim=True)
        tr_pred = tr_pred / (tr_norm + 1e-12) * self.tr_final_layer(tr_norm, sigma_emb)
        rot_norm = torch.linalg.norm(rot_pred, dim=1, keepdim=True)
        rot_pred = rot_pred / (rot_norm + 1e-12) * self.rot_final_layer(rot_norm, sigma_emb)
        if c.scale_by_sigma:
            tr_pred = tr_pred / tr_sigma[:, None]
            rot_pred = rot_pred * so3.score_norm(rot_sigma)[:, None]

        R = batch.tor_src.shape[1]
        if c.no_torsion:
            return ScoreOutput(tr_pred, rot_pred, tr_pred.new_zeros(B, R))

        # torsion head: each rotatable bond's center convolves the ligand atoms
        pu = gather_nodes(batch.lig_pos, batch.tor_src)
        pv = gather_nodes(batch.lig_pos, batch.tor_dst)
        bond_pos, bond_vec = (pu + pv) / 2, pv - pu
        tb_mask, tb_d = radius_mask(bond_pos, batch.lig_pos, c.lig_max_radius, batch.tor_mask, batch.lig_mask)
        tb_vec = batch.lig_pos[:, None, :, :] - bond_pos[:, :, None, :]
        tb_sh0 = spherical_harmonics(c.sh_lmax, tb_vec)
        bond_sh2 = spherical_harmonics(2, bond_vec)[..., 4:]  # the l=2 block
        tb_sh = self.final_tp_tor(tb_sh0, bond_sh2[:, :, None, :].expand(tb_sh0.shape[:-1] + (5,)))
        tb_emb = self.final_edge_embedding(self.lig_distance_expansion(tb_d))
        tor_bond_attr = gather_nodes(lig_attr, batch.tor_src) + gather_nodes(lig_attr, batch.tor_dst)
        eattr_t = torch.cat(
            [
                tb_emb,
                lig_attr[:, None, :, :ns].expand(tb_emb.shape[:-1] + (ns,)),
                tor_bond_attr[:, :, None, :ns].expand(tb_emb.shape[:-1] + (ns,)),
            ],
            dim=-1,
        )
        sender_t = lig_attr[:, None, :, :].expand(tb_emb.shape[:-1] + (lig_attr.shape[-1],))
        msg_t = self.tor_bond_conv.messages(0, sender_t, tb_sh, eattr_t, tb_mask)
        tor_feat = self.tor_bond_conv.finalize(None, msg_t.sum(dim=2), tb_mask.sum(dim=2).to(msg_t.dtype), batch.tor_mask)
        tor_pred = self.tor_final_layer(tor_feat)[..., 0]
        if c.scale_by_sigma:
            tor_pred = tor_pred * torch.sqrt(torus.score_norm(tor_sigma))[:, None]
        return ScoreOutput(tr_pred, rot_pred, torch.where(batch.tor_mask, tor_pred, torch.zeros_like(tor_pred)))


class MaskedBatchNorm1d(nn.Module):
    """Plain batch norm over the last axis at inference (running statistics):
    (x - mean) / sqrt(var + eps) * scale + bias."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x):
        return (x - self.mean) / torch.sqrt(self.var + self.epsilon) * self.scale + self.bias


class ConfidenceHead(nn.Module):
    """(Linear, batch norm, ReLU) x 2, then Linear: the confidence predictor."""

    def __init__(self, in_dim: int, ns: int, out_dim: int, use_batchnorm: bool = True):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns), nn.Linear(ns, ns), nn.Linear(ns, out_dim)])
        self.norms = nn.ModuleList(MaskedBatchNorm1d(ns) for _ in range(2)) if use_batchnorm else None

    def forward(self, x):
        for i in range(2):
            x = self.layers[i](x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = torch.relu(x)
        return self.layers[2](x)


def init_weights(model: nn.Module, seed: int) -> None:
    """Random weights from ``seed`` (torch.Generator on the CPU, so the same
    seed gives the same model on every device): linear layers uniform in
    +-1/sqrt(fan_in), embeddings Xavier-uniform, batch norm at identity."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            bound = mod.in_features ** -0.5
            mod.weight.data = (torch.rand(mod.weight.shape, generator=gen) * 2 - 1) * bound
            if mod.bias is not None:
                mod.bias.data = (torch.rand(mod.bias.shape, generator=gen) * 2 - 1) * bound
        elif isinstance(mod, nn.Embedding):
            bound = (6.0 / sum(mod.weight.shape)) ** 0.5
            mod.weight.data = (torch.rand(mod.weight.shape, generator=gen) * 2 - 1) * bound
