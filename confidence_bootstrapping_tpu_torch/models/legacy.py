"""The legacy architectures: DiffDock's original score model and the
all-atom confidence and affinity model (``--old_score_model``).

Port of ``confidence_bootstrapping_tpu/models/legacy.py`` (the reference's
``old_score_model.py`` and ``old_all_atom_score_model.py``). What sets them
apart from the modern models (``score_model.py``, ``all_atom_model.py``):

* no embedding phase: the trunk starts from the node embeddings, so there is
  no cacheable receptor phase (``forward`` accepts and ignores
  ``rec_cache``; the sampler passes None);
* one ``TPConv`` per edge group and depth (lig, rec <- lig ... in their own
  lists), each with its own batch norm and ``residual=False``; the residual
  is ``pad(node) + sum(updates)``;
* the trunk keeps its pseudoscalars (``get_irrep_seq(ns, nv, False,
  use_second_order_repr)``) and sh_lmax is 2 in the published models;
* optional smooth edge weights 0.5 (cos(pi d / cutoff) + 1), a per-noise
  sigma embedding (``separate_noise_schedule``), the old atom encoder
  (``use_old_atom_encoder``), zeroed residue identities
  (``no_aminoacid_identities``);
* the confidence head on ``[scal | last-ns scal]``; with ``parallel > 1``
  it emits a filtering logit and ns pose features per pose, and the affinity
  head reads their aggregates over each group of ``parallel`` consecutive
  batch elements.

The flipped groups (receptor <- ligand, atom <- ligand, receptor <- atom)
take the unreversed harmonics of their edges, as the reference does:
converted weights depend on it.

At inference every group's per-edge messages go through the edge-list kernel
(``TPConv(edge_kernel=True)``: row 6's ``fused_tpconv_msgs`` at lmax=1 on
the irreps ladder, ``fused_tpconv_edge`` per edge at lmax=2 or on the
second-order ladder, ``use_second_order_repr``; a launch no build fits
raises), in
training through the differentiable edge-list op, and the smooth weight
multiplies the result (the TP is linear in its weights). Only the torsion
head at lmax=2, whose harmonics reach l=4 and no kernel takes, computes its
messages in plain PyTorch (the JAX package's plain TP).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import ScoreModelConfig
from ..data.complex_graph import ComplexBatch
from ..data.vocab import LIG_FEATURE_DIMS, REC_ATOM_FEATURE_DIMS, REC_RESIDUE_FEATURE_DIMS
from ..ops import so3, torus
from ..ops.graph_builders import gather_nodes, pairwise_dist, radius_mask, scatter_mean_to_nodes, topk_neighbors
from ..ops.irreps import FullTensorProduct, Irreps, spherical_harmonics, spherical_harmonics_irreps
from ..ops.schedules import get_timestep_embedding, t_to_sigma
from ..runtime import resolve_device
from .layers import AtomEncoder, FCBlock, GaussianSmearing, TPConv, pad_residual
from .score_model import ConfidenceHead, ConfidenceOutput, FinalNormMLP, ScoreOutput, TorFinalMLP, get_irrep_seq, init_weights


class OldAtomEncoder(nn.Module):
    """The reference's OldAtomEncoder: categorical embeddings summed, the
    scalars added through their own linear, then an optional merge layer
    over [embedding | language-model features]."""

    def __init__(self, emb_dim: int, feature_dims: Sequence[int], n_scalar: int = 0, lm_dim: int = 0):
        super().__init__()
        self.feature_dims = tuple(feature_dims)
        self.embeddings = nn.ModuleList(nn.Embedding(v, emb_dim) for v in self.feature_dims)
        layers = [nn.Linear(n_scalar, emb_dim)] if n_scalar > 0 else []
        if lm_dim > 0:
            layers.append(nn.Linear(emb_dim + lm_dim, emb_dim))
        self.layers = nn.ModuleList(layers)
        self.n_scalar, self.lm_dim = n_scalar, lm_dim

    def forward(self, x_cat, x_scalar=None, x_lm=None):
        emb = 0.0
        for i, (table, vocab) in enumerate(zip(self.embeddings, self.feature_dims)):
            emb = emb + table(torch.clamp(x_cat[..., i], 0, vocab - 1))
        k = 0
        if self.n_scalar > 0:
            emb = emb + self.layers[0](x_scalar)
            k = 1
        if self.lm_dim > 0:
            emb = self.layers[k](torch.cat([emb, x_lm], dim=-1))
        return emb


class NewAtomEncoderLM(AtomEncoder):
    """The reference's other legacy encoder: one linear over [embedding |
    scalars | language-model features]."""

    def __init__(self, emb_dim: int, feature_dims: Sequence[int], n_scalar: int = 0, lm_dim: int = 0):
        super().__init__(emb_dim, feature_dims, n_scalar + lm_dim)

    def forward(self, x_cat, x_scalar=None, x_lm=None):
        extras = [x for x in (x_scalar, x_lm) if x is not None]
        return super().forward(x_cat, torch.cat(extras, dim=-1) if extras else None)


def _smooth_weight(d, cutoff, enabled: bool):
    if not enabled:
        return None
    x = torch.clamp(d * np.pi / cutoff, max=np.pi)
    return 0.5 * (torch.cos(x) + 1.0)


# pose-feature aggregators over a group's poses for the affinity head (std as torch.std: ddof 1)
_AGGREGATORS = {
    "mean": lambda x: torch.mean(x, dim=1),
    "max": lambda x: torch.amax(x, dim=1),
    "min": lambda x: torch.amin(x, dim=1),
    "std": lambda x: torch.std(x, dim=1, correction=1),
}


def _setup_confidence_head(model: nn.Module, c: ScoreModelConfig) -> None:
    """The confidence head and, with ``parallel > 1``, the affinity head."""
    ns = c.ns
    bn = not c.confidence_no_batchnorm
    if c.parallel > 1:
        if not c.affinity_prediction:
            raise ValueError("parallel > 1 requires affinity_prediction")
        out_dim = 1 + ns  # [filtering | pose features for the affinity]
        n_agg = len(c.parallel_aggregators.split(" "))
        model.affinity_predictor = ConfidenceHead(ns * n_agg, ns, 1, bn, c.confidence_dropout)
    else:
        out_dim = c.num_confidence_outputs + (1 if c.affinity_prediction else 0)
    head_in = 2 * ns if c.num_conv_layers >= 3 else ns
    model.confidence_predictor = ConfidenceHead(head_in, ns, out_dim, bn, c.confidence_dropout)


def _setup_score_heads(model: nn.Module, c: ScoreModelConfig, sh: str, final_irreps: str, sig: int) -> None:
    """The center convolution with the tr/rot heads and the torsion head."""
    ns, p = c.ns, c.dropout
    model.center_distance_expansion = GaussianSmearing(0.0, c.center_max_distance, c.distance_embed_dim)
    model.center_edge_embedding = FCBlock(c.distance_embed_dim + sig, ns, ns, dropout=p)
    model.final_conv = TPConv(final_irreps, sh, "2x1o + 2x1e" if not c.odd_parity else "1x1o + 1x1e", 2 * ns,
                              batch_norm=c.batch_norm, residual=False, dropout=p, edge_kernel=True)
    model.tr_final_layer = FinalNormMLP(1 + sig, ns, p)
    model.rot_final_layer = FinalNormMLP(1 + sig, ns, p)
    if not c.no_torsion:
        model.final_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns, dropout=p)
        model.final_tp_tor = FullTensorProduct(sh, "1x2e")
        tor_out = f"{ns}x0o + {ns}x0e" if not c.odd_parity else f"{ns}x0o"
        model.tor_bond_conv = TPConv(final_irreps, str(model.final_tp_tor.irreps_out), tor_out, 3 * ns,
                                     batch_norm=c.batch_norm, residual=False, dropout=p, edge_kernel=True)
        model.tor_final_layer = TorFinalMLP(Irreps(tor_out).dim, ns, p)


class _LegacyBase(nn.Module):
    """What both legacy models share: encoders, edge embeddings, the trunk's
    layer factory, the heads and their forward."""

    def _common(self, c: ScoreModelConfig):
        self.cfg = c
        ns = c.ns
        self.sigma_dim = sig = c.sigma_embed_dim * (3 if c.separate_noise_schedule else 1)
        self.sh = str(spherical_harmonics_irreps(c.sh_lmax))
        self.timestep_emb = get_timestep_embedding(c.embedding_type, c.sigma_embed_dim, c.embedding_scale)
        enc = OldAtomEncoder if c.use_old_atom_encoder else NewAtomEncoderLM
        self.lig_node_embedding = enc(ns, LIG_FEATURE_DIMS, n_scalar=sig)
        self.rec_node_embedding = enc(ns, REC_RESIDUE_FEATURE_DIMS, n_scalar=sig, lm_dim=c.lm_embedding_dim)
        self.lig_edge_embedding = FCBlock(c.in_lig_edge_features + sig + c.distance_embed_dim, ns, ns,
                                          dropout=c.dropout)
        self.rec_edge_embedding = FCBlock(sig + c.distance_embed_dim, ns, ns, dropout=c.dropout)
        self.lig_distance_expansion = GaussianSmearing(0.0, c.lig_max_radius, c.distance_embed_dim)
        self.rec_distance_expansion = GaussianSmearing(0.0, c.rec_max_radius, c.distance_embed_dim)
        self.cross_distance_expansion = GaussianSmearing(0.0, c.cross_max_distance, c.cross_distance_embed_dim)
        self.irrep_seq = get_irrep_seq(ns, c.nv, False, c.use_second_order_repr)
        self.final_irreps = self.irrep_seq[min(c.num_conv_layers, 3)]

    def _conv(self, i: int) -> TPConv:
        c, seq = self.cfg, self.irrep_seq
        return TPConv(seq[min(i, 3)], self.sh, seq[min(i + 1, 3)], 3 * c.ns, hidden_features=3 * c.ns,
                      batch_norm=c.batch_norm, residual=False, dropout=c.dropout, edge_kernel=True)

    def _convs(self, n: int) -> nn.ModuleList:
        return nn.ModuleList(self._conv(i) for i in range(n))

    def _finish(self, device, seed: int):
        c = self.cfg
        if c.confidence_mode:
            _setup_confidence_head(self, c)
        else:
            _setup_score_heads(self, c, self.sh, self.final_irreps, self.sigma_dim)
        init_weights(self, seed)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    # ------------------------------------------------------------------ #

    def _sigmas(self, batch: ComplexBatch):
        """(tr, rot, tor sigmas, sigma embedding [B, sigma_dim])."""
        c = self.cfg
        if c.confidence_mode:  # the confidence model takes the times as the sigmas
            sigmas = (batch.t_tr, batch.t_rot, batch.t_tor)
        else:
            sigmas = t_to_sigma(batch.t_tr, batch.t_rot, batch.t_tor, c.sigma)
        if c.separate_noise_schedule:
            emb = torch.cat([self.timestep_emb(t) for t in (batch.t_tr, batch.t_rot, batch.t_tor)], dim=-1)
        else:
            emb = self.timestep_emb(batch.t_tr)
        return sigmas + (emb,)

    @staticmethod
    def _se(sigma_emb, lead):
        """The sigma embedding broadcast to lead + (sigma_dim,)."""
        B, D = sigma_emb.shape
        return sigma_emb.reshape((B,) + (1,) * (len(lead) - 1) + (D,)).expand(tuple(lead) + (D,))

    def _embed_nodes(self, batch: ComplexBatch, sigma_emb):
        c = self.cfg
        B, L = batch.lig_mask.shape
        N = batch.rec_mask.shape[1]
        lig_attr = self.lig_node_embedding(batch.lig_f, self._se(sigma_emb, (B, L)))
        lm = batch.rec_lm if c.lm_embedding_dim else None
        rec_f = batch.rec_f * 0 if c.no_aminoacid_identities else batch.rec_f
        rec_attr = self.rec_node_embedding(rec_f[..., None], self._se(sigma_emb, (B, N)), lm)
        return lig_attr, rec_attr

    def _edges(self, embedding: FCBlock, d, expansion: GaussianSmearing, sigma_emb, det, gen, cutoff=None):
        """(edge embedding of [sigma | expanded distance], smooth weight or None)."""
        emb = embedding(torch.cat([self._se(sigma_emb, d.shape), expansion(d)], dim=-1), det, gen)
        return emb, _smooth_weight(d, self.cfg.rec_max_radius if cutoff is None else cutoff, self.cfg.smooth_edges)

    def _lig_graph(self, batch: ComplexBatch, sigma_emb, det, gen) -> dict:
        """Dense radius pairs and bond edges, one edge MLP over
        [bond features | sigma | distance]."""
        c = self.cfg
        pos = batch.lig_pos
        L = pos.shape[1]
        pair_d = pairwise_dist(pos, pos)
        eye = torch.eye(L, dtype=torch.bool, device=pos.device)[None]
        pair_mask = (pair_d < c.lig_max_radius) & batch.lig_mask[:, :, None] & batch.lig_mask[:, None, :] & ~eye
        pair_sh = spherical_harmonics(c.sh_lmax, pos[:, None, :, :] - pos[:, :, None, :])
        zeros_bond = pair_d.new_zeros(pair_d.shape + (c.in_lig_edge_features,))
        pair_emb = self.lig_edge_embedding(
            torch.cat([zeros_bond, self._se(sigma_emb, pair_d.shape), self.lig_distance_expansion(pair_d)], -1),
            det, gen)
        bvec = gather_nodes(pos, batch.lig_edge_dst) - gather_nodes(pos, batch.lig_edge_src)
        bd = torch.linalg.norm(bvec, dim=-1)
        bond_emb = self.lig_edge_embedding(
            torch.cat([batch.lig_edge_attr, self._se(sigma_emb, bd.shape), self.lig_distance_expansion(bd)], -1),
            det, gen)
        return dict(pair_mask=pair_mask, pair_sh=pair_sh, pair_emb=pair_emb,
                    pair_w=_smooth_weight(pair_d, c.lig_max_radius, c.smooth_edges),
                    bond_sh=spherical_harmonics(c.sh_lmax, bvec), bond_emb=bond_emb,
                    bond_w=_smooth_weight(bd, c.lig_max_radius, c.smooth_edges))

    def _lig_intra(self, layer: TPConv, lig_attr, g: dict, batch: ComplexBatch, det, ura, gen):
        """ligand <- ligand (pairs + bonds) through one layer."""
        ns = self.cfg.ns
        L = lig_attr.shape[1]
        scal = lig_attr[..., :ns]
        pe = g["pair_emb"]
        ea_p = torch.cat([pe, scal[:, :, None, :].expand(pe.shape[:-1] + (ns,)),
                          scal[:, None, :, :].expand(pe.shape[:-1] + (ns,))], -1)
        sender_p = lig_attr[:, None, :, :].expand(pe.shape[:-1] + (lig_attr.shape[-1],))
        msg_p = layer.messages(0, sender_p, g["pair_sh"], ea_p, g["pair_mask"], det, gen, edge_weight=g["pair_w"])
        src, dst = batch.lig_edge_src, batch.lig_edge_dst
        sender_b = gather_nodes(lig_attr, dst)
        ea_b = torch.cat([g["bond_emb"], gather_nodes(scal, src), sender_b[..., :ns]], -1)
        msg_b = layer.messages(0, sender_b, g["bond_sh"], ea_b, batch.lig_edge_mask, det, gen,
                               edge_weight=g["bond_w"])
        s_b, c_b = scatter_mean_to_nodes(msg_b, src, batch.lig_edge_mask, L)
        return layer.finalize(None, msg_p.sum(dim=2) + s_b, g["pair_mask"].sum(-1).to(torch.float32) + c_b,
                              batch.lig_mask, ura)

    @staticmethod
    def _recv_attr(emb, recv_scal, sender_scal):
        """[edge embedding | receiver scalars | sender scalars] over [B, M, K, *] edges."""
        ns = recv_scal.shape[-1]
        return torch.cat([emb, recv_scal[:, :, None, :].expand(emb.shape[:-1] + (ns,)), sender_scal], -1)

    def _knn(self, layer: TPConv, attr, nbr, sh, emb, w, nbr_mask, node_mask, det, ura, gen):
        """A node set <- itself over its kNN lists."""
        ns = self.cfg.ns
        sender = gather_nodes(attr, nbr)
        ea = self._recv_attr(emb, attr[..., :ns], sender[..., :ns])
        msg = layer.messages(0, sender, sh, ea, nbr_mask, det, gen, edge_weight=w)
        return layer.finalize(None, msg.sum(dim=2), nbr_mask.sum(-1).to(torch.float32), node_mask, ura)

    def _cross(self, layer: TPConv, lig_attr, sender, sh, emb, w, mask, lig_mask, det, ura, gen):
        """ligand <- another node set over its capped lists [B, L, K]."""
        ns = self.cfg.ns
        ea = self._recv_attr(emb, lig_attr[..., :ns], sender[..., :ns])
        msg = layer.messages(0, sender, sh, ea, mask, det, gen, edge_weight=w)
        return layer.finalize(None, msg.sum(dim=2), mask.sum(-1).to(torch.float32), lig_mask, ura)

    def _flipped(self, layer: TPConv, lig_attr, sender, idx, sh, emb, w, mask, n_nodes: int, node_mask, ea_order,
                 det, ura, gen):
        """another node set <- ligand over the ligand's lists, scattered to
        the other set; the unreversed harmonics (the reference's quirk).
        ``ea_order``: 'lig_first' for [emb | lig | other], else
        [emb | other | lig]."""
        ns = self.cfg.ns
        B = lig_attr.shape[0]
        lig_scal = lig_attr[:, :, None, :ns].expand(emb.shape[:-1] + (ns,))
        parts = [emb, lig_scal, sender[..., :ns]] if ea_order == "lig_first" else [emb, sender[..., :ns], lig_scal]
        lig_bc = lig_attr[:, :, None, :].expand(emb.shape[:-1] + (lig_attr.shape[-1],))
        msg = layer.messages(0, lig_bc, sh, torch.cat(parts, -1), mask, det, gen, edge_weight=w)
        s, cnt = scatter_mean_to_nodes(msg.reshape(B, -1, msg.shape[-1]), idx.reshape(B, -1), mask.reshape(B, -1),
                                       n_nodes)
        return layer.finalize(None, s, cnt, node_mask, ura)

    def _cross_lists(self, embedding: FCBlock, batch: ComplexBatch, tr_sigma, sigma_emb, det, gen):
        """The ligand <- receptor capped lists (dynamic sigma cutoff), their
        edges embedded by ``embedding``: (idx, mask, harmonics, embedding,
        smooth weight)."""
        c = self.cfg
        N = batch.rec_pos.shape[1]
        cutoff = (tr_sigma * 3 + 20)[:, None, None] if c.dynamic_max_cross else c.cross_max_distance
        idx, mask, d = topk_neighbors(batch.lig_pos, batch.rec_pos, cutoff, batch.lig_mask, batch.rec_mask,
                                      c.effective_cross_cap(N))
        sh = spherical_harmonics(c.sh_lmax, gather_nodes(batch.rec_pos, idx) - batch.lig_pos[:, :, None, :])
        emb, w = self._edges(embedding, d, self.cross_distance_expansion, sigma_emb, det, gen, cutoff)
        return idx, mask, sh, emb, w

    def _rec_knn(self, batch: ComplexBatch, sigma_emb, det, gen):
        vec = gather_nodes(batch.rec_pos, batch.rec_nbr) - batch.rec_pos[:, :, None, :]
        emb, w = self._edges(self.rec_edge_embedding, torch.linalg.norm(vec, dim=-1), self.rec_distance_expansion,
                             sigma_emb, det, gen)
        return spherical_harmonics(self.cfg.sh_lmax, vec), emb, w

    # ------------------------------------------------------------------ #
    # heads
    # ------------------------------------------------------------------ #

    def _heads(self, batch, lig_attr, sigmas, det, ura, gen):
        if self.cfg.confidence_mode:
            return self._confidence_output(lig_attr, batch, det, ura, gen)
        return self._score_heads(batch, lig_attr, *sigmas, det, ura, gen)

    def _confidence_output(self, lig_attr, batch: ComplexBatch, det, ura, gen) -> ConfidenceOutput:
        """Pooled ligand scalars -> confidence head; with ``parallel > 1`` the
        filtering logits [B / P, P] and one affinity per group of P
        consecutive batch elements."""
        c = self.cfg
        ns = c.ns
        scal = (torch.cat([lig_attr[..., :ns], lig_attr[..., -ns:]], dim=-1) if c.num_conv_layers >= 3
                else lig_attr[..., :ns])
        m = batch.lig_mask.to(scal.dtype)[..., None]
        pooled = torch.sum(scal * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        conf = self.confidence_predictor(pooled, None, det, ura, gen)
        if c.parallel > 1:
            P = c.parallel
            filtering = conf[:, 0].reshape(-1, P)
            pose_feat = conf[:, 1:].reshape(-1, P, ns)
            agg = torch.cat([_AGGREGATORS[a](pose_feat) for a in c.parallel_aggregators.split(" ")], dim=-1)
            affinity = self.affinity_predictor(agg, None, det, ura, gen)[..., 0]
            return ConfidenceOutput(filtering, affinity=affinity)
        if c.num_confidence_outputs == 1 and not c.affinity_prediction:
            conf = conf[..., 0]
        return ConfidenceOutput(conf)

    def _score_heads(self, batch: ComplexBatch, lig_attr, tr_sigma, rot_sigma, tor_sigma, sigma_emb, det, ura,
                     gen) -> ScoreOutput:
        c = self.cfg
        ns = c.ns
        B = lig_attr.shape[0]
        m = batch.lig_mask.to(lig_attr.dtype)[..., None]
        center = torch.sum(batch.lig_pos * m, dim=1, keepdim=True) / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        cvec = batch.lig_pos - center
        cd = torch.linalg.norm(cvec, dim=-1)
        csh = spherical_harmonics(c.sh_lmax, cvec)
        cattr = self.center_edge_embedding(
            torch.cat([self.center_distance_expansion(cd), self._se(sigma_emb, cd.shape)], -1), det, gen)
        cattr = torch.cat([cattr, lig_attr[..., :ns]], dim=-1)
        msg_c = self.final_conv.messages(0, lig_attr, csh, cattr, batch.lig_mask, det, gen)
        global_pred = self.final_conv.finalize(None, msg_c.sum(dim=1), batch.lig_mask.sum(dim=1).to(msg_c.dtype),
                                               torch.ones(B, dtype=torch.bool, device=msg_c.device), ura)
        if c.odd_parity:
            tr_pred, rot_pred = global_pred[:, :3], global_pred[:, 3:6]
        else:
            tr_pred = global_pred[:, :3] + global_pred[:, 6:9]
            rot_pred = global_pred[:, 3:6] + global_pred[:, 9:12]
        tr_norm = torch.linalg.norm(tr_pred, dim=1, keepdim=True)
        tr_pred = tr_pred / (tr_norm + 1e-12) * self.tr_final_layer(tr_norm, sigma_emb, det, gen)
        rot_norm = torch.linalg.norm(rot_pred, dim=1, keepdim=True)
        rot_pred = rot_pred / (rot_norm + 1e-12) * self.rot_final_layer(rot_norm, sigma_emb, det, gen)
        if c.scale_by_sigma:
            tr_pred = tr_pred / tr_sigma[:, None]
            rot_pred = rot_pred * so3.score_norm(rot_sigma)[:, None]
        if c.no_torsion:
            return ScoreOutput(tr_pred, rot_pred, tr_pred.new_zeros(B, batch.tor_src.shape[1]))

        pu = gather_nodes(batch.lig_pos, batch.tor_src)
        pv = gather_nodes(batch.lig_pos, batch.tor_dst)
        bond_pos, bond_vec = (pu + pv) / 2, pv - pu
        tb_mask, tb_d = radius_mask(bond_pos, batch.lig_pos, c.lig_max_radius, batch.tor_mask, batch.lig_mask)
        tb_sh0 = spherical_harmonics(c.sh_lmax, batch.lig_pos[:, None, :, :] - bond_pos[:, :, None, :])
        bond_sh2 = spherical_harmonics(2, bond_vec)[..., 4:]
        tb_sh = self.final_tp_tor(tb_sh0, bond_sh2[:, :, None, :].expand(tb_sh0.shape[:-1] + (5,)))
        tb_emb = self.final_edge_embedding(self.lig_distance_expansion(tb_d), det, gen)
        tor_bond_attr = gather_nodes(lig_attr, batch.tor_src) + gather_nodes(lig_attr, batch.tor_dst)
        eattr_t = torch.cat([tb_emb, lig_attr[:, None, :, :ns].expand(tb_emb.shape[:-1] + (ns,)),
                             tor_bond_attr[:, :, None, :ns].expand(tb_emb.shape[:-1] + (ns,))], -1)
        sender_t = lig_attr[:, None, :, :].expand(tb_emb.shape[:-1] + (lig_attr.shape[-1],))
        msg_t = self.tor_bond_conv.messages(0, sender_t, tb_sh, eattr_t, tb_mask, det, gen,
                                            edge_weight=_smooth_weight(tb_d, c.lig_max_radius, c.smooth_edges))
        tor_feat = self.tor_bond_conv.finalize(None, msg_t.sum(dim=2), tb_mask.sum(dim=2).to(msg_t.dtype),
                                               batch.tor_mask, ura)
        tor_pred = self.tor_final_layer(tor_feat, det, gen)[..., 0]
        tor_pred = torch.where(batch.tor_mask, tor_pred, torch.zeros_like(tor_pred))
        if c.scale_by_sigma:
            tor_pred = tor_pred * torch.sqrt(torus.score_norm(tor_sigma))[:, None]
        return ScoreOutput(tr_pred, rot_pred, tor_pred)


class OldTensorProductScoreModel(_LegacyBase):
    """DiffDock's original residue-level score model (and its confidence
    mode): four groups a depth (lig, rec, rec <- lig, lig <- rec); the last
    depth updates the ligand only. Built on ``device`` (default: the GPU)
    with weights drawn from ``seed``."""

    def __init__(self, cfg: ScoreModelConfig, device=None, seed: int = 0):
        super().__init__()
        self._common(cfg)
        c = cfg
        self.cross_edge_embedding = FCBlock(self.sigma_dim + c.cross_distance_embed_dim, c.ns, c.ns, dropout=c.dropout)
        n = c.num_conv_layers
        self.lig_conv_layers = self._convs(n)
        self.rec_conv_layers = self._convs(n - 1)
        self.lig_to_rec_conv_layers = self._convs(n - 1)
        self.rec_to_lig_conv_layers = self._convs(n)
        self._finish(device, seed)

    def forward(self, batch: ComplexBatch, rec_cache=None, deterministic: bool = True,
                use_running_average: bool = True, generator: Optional[torch.Generator] = None):
        """Scores (``ScoreOutput``) or, in confidence mode, confidences
        (``ConfidenceOutput``). ``rec_cache`` is accepted and ignored."""
        det, ura, gen = deterministic, use_running_average, generator
        N = batch.rec_pos.shape[1]
        sigmas = self._sigmas(batch)
        sigma_emb = sigmas[-1]
        lig_attr, rec_attr = self._embed_nodes(batch, sigma_emb)
        lig_g = self._lig_graph(batch, sigma_emb, det, gen)
        rec_sh, rec_emb, rec_w = self._rec_knn(batch, sigma_emb, det, gen)
        cr_idx, cr_mask, cr_sh, cr_emb, cr_w = self._cross_lists(self.cross_edge_embedding, batch, sigmas[0], sigma_emb,
                                                                 det, gen)

        n = len(self.lig_conv_layers)
        for l in range(n):
            last = l == n - 1
            lig_intra = self._lig_intra(self.lig_conv_layers[l], lig_attr, lig_g, batch, det, ura, gen)
            cr_sender = gather_nodes(rec_attr, cr_idx)
            lig_inter = self._cross(self.rec_to_lig_conv_layers[l], lig_attr, cr_sender, cr_sh, cr_emb, cr_w, cr_mask,
                                    batch.lig_mask, det, ura, gen)
            if not last:
                rec_intra = self._knn(self.rec_conv_layers[l], rec_attr, batch.rec_nbr, rec_sh, rec_emb, rec_w,
                                      batch.rec_nbr_mask, batch.rec_mask, det, ura, gen)
                rec_inter = self._flipped(self.lig_to_rec_conv_layers[l], lig_attr, cr_sender, cr_idx, cr_sh, cr_emb,
                                          cr_w, cr_mask, N, batch.rec_mask, "lig_first", det, ura, gen)
            lig_attr = pad_residual(lig_attr, lig_intra.shape[-1]) + lig_intra + lig_inter
            if not last:
                rec_attr = pad_residual(rec_attr, rec_intra.shape[-1]) + rec_intra + rec_inter
        return self._heads(batch, lig_attr, sigmas, det, ura, gen)


# the reference's flat conv_layers order, 9 a depth: our per-group lists
LEGACY_AA_GROUPS = ("lig_conv_layers", "lr_conv_layers", "la_conv_layers", "atom_conv_layers", "al_conv_layers",
                    "ar_conv_layers", "rec_conv_layers", "rl_conv_layers", "ra_conv_layers")


class OldAllAtomScoreModel(_LegacyBase):
    """The legacy all-atom score, confidence and affinity model: ligand
    atoms, receptor residues and receptor atoms, nine groups a depth (lig <-
    {lig, rec, atom} at every depth, atom <- {atom, lig, rec} and rec <-
    {rec, lig, atom} but at the last). Ligand <- atom lists take the cross
    distance expansion despite their 5 A radius, as the reference does."""

    def __init__(self, cfg: ScoreModelConfig, device=None, seed: int = 0):
        super().__init__()
        self._common(cfg)
        c, sig, ns, p = cfg, self.sigma_dim, cfg.ns, cfg.dropout
        self.atom_node_embedding = (OldAtomEncoder if c.use_old_atom_encoder else NewAtomEncoderLM)(
            ns, REC_ATOM_FEATURE_DIMS, n_scalar=sig)
        self.atom_edge_embedding = FCBlock(sig + c.distance_embed_dim, ns, ns, dropout=p)
        self.lr_edge_embedding = FCBlock(sig + c.cross_distance_embed_dim, ns, ns, dropout=p)
        self.ar_edge_embedding = FCBlock(sig + c.distance_embed_dim, ns, ns, dropout=p)
        self.la_edge_embedding = FCBlock(sig + c.cross_distance_embed_dim, ns, ns, dropout=p)
        n = c.num_conv_layers
        for g, name in enumerate(LEGACY_AA_GROUPS):
            setattr(self, name, self._convs(n if g < 3 else n - 1))
        self._finish(device, seed)

    def forward(self, batch: ComplexBatch, rec_cache=None, deterministic: bool = True,
                use_running_average: bool = True, generator: Optional[torch.Generator] = None):
        """As ``OldTensorProductScoreModel.forward``, with receptor atoms."""
        c = self.cfg
        det, ura, gen = deterministic, use_running_average, generator
        B = batch.lig_pos.shape[0]
        N, A = batch.rec_pos.shape[1], batch.atom_pos.shape[1]
        sigmas = self._sigmas(batch)
        sigma_emb = sigmas[-1]
        lig_attr, rec_attr = self._embed_nodes(batch, sigma_emb)
        atom_attr = self.atom_node_embedding(batch.atom_f, self._se(sigma_emb, (B, A)))
        lig_g = self._lig_graph(batch, sigma_emb, det, gen)
        rec_sh, rec_emb, rec_w = self._rec_knn(batch, sigma_emb, det, gen)

        a_vec = gather_nodes(batch.atom_pos, batch.atom_nbr) - batch.atom_pos[:, :, None, :]
        atom_sh = spherical_harmonics(c.sh_lmax, a_vec)
        atom_emb, atom_w = self._edges(self.atom_edge_embedding, torch.linalg.norm(a_vec, dim=-1),
                                       self.lig_distance_expansion, sigma_emb, det, gen, c.lig_max_radius)
        ar_vec = gather_nodes(batch.rec_pos, batch.atom_res) - batch.atom_pos
        ar_sh = spherical_harmonics(c.sh_lmax, ar_vec)
        ar_emb = self._edges(self.ar_edge_embedding, torch.linalg.norm(ar_vec, dim=-1), self.rec_distance_expansion,
                             sigma_emb, det, gen)[0]  # the atom -> residue edge has weight 1
        lr_idx, lr_mask, lr_sh, lr_emb, lr_w = self._cross_lists(self.lr_edge_embedding, batch, sigmas[0], sigma_emb,
                                                                 det, gen)
        la_idx, la_mask, la_d = topk_neighbors(batch.lig_pos, batch.atom_pos, c.lig_max_radius, batch.lig_mask,
                                               batch.atom_mask, min(A, c.atom_cross_cap))
        la_sh = spherical_harmonics(c.sh_lmax, gather_nodes(batch.atom_pos, la_idx) - batch.lig_pos[:, :, None, :])
        la_emb, la_w = self._edges(self.la_edge_embedding, la_d, self.cross_distance_expansion, sigma_emb, det, gen,
                                   c.lig_max_radius)
        atom_cnt = batch.atom_mask.to(torch.float32)

        n = len(self.lig_conv_layers)
        for l in range(n):
            last = l == n - 1
            rec_scal_at_atom = gather_nodes(rec_attr[..., :c.ns], batch.atom_res)
            atom_scal = atom_attr[..., :c.ns]
            lig_intra = self._lig_intra(self.lig_conv_layers[l], lig_attr, lig_g, batch, det, ura, gen)
            lr_sender = gather_nodes(rec_attr, lr_idx)
            lig_rec = self._cross(self.lr_conv_layers[l], lig_attr, lr_sender, lr_sh, lr_emb, lr_w, lr_mask,
                                  batch.lig_mask, det, ura, gen)
            la_sender = gather_nodes(atom_attr, la_idx)
            lig_atom = self._cross(self.la_conv_layers[l], lig_attr, la_sender, la_sh, la_emb, la_w, la_mask,
                                   batch.lig_mask, det, ura, gen)
            if not last:
                atom_intra = self._knn(self.atom_conv_layers[l], atom_attr, batch.atom_nbr, atom_sh, atom_emb, atom_w,
                                       batch.atom_nbr_mask, batch.atom_mask, det, ura, gen)
                atom_lig = self._flipped(self.al_conv_layers[l], lig_attr, la_sender, la_idx, la_sh, la_emb, la_w,
                                         la_mask, A, batch.atom_mask, "other_first", det, ura, gen)
                layer = self.ar_conv_layers[l]  # atom <- its residue
                msg = layer.messages(0, gather_nodes(rec_attr, batch.atom_res), ar_sh,
                                     torch.cat([ar_emb, atom_scal, rec_scal_at_atom], -1), batch.atom_mask, det, gen)
                atom_rec = layer.finalize(None, msg, atom_cnt, batch.atom_mask, ura)
                rec_intra = self._knn(self.rec_conv_layers[l], rec_attr, batch.rec_nbr, rec_sh, rec_emb, rec_w,
                                      batch.rec_nbr_mask, batch.rec_mask, det, ura, gen)
                rec_lig = self._flipped(self.rl_conv_layers[l], lig_attr, lr_sender, lr_idx, lr_sh, lr_emb, lr_w,
                                        lr_mask, N, batch.rec_mask, "other_first", det, ura, gen)
                layer = self.ra_conv_layers[l]  # residue <- its atoms
                msg = layer.messages(0, atom_attr, ar_sh, torch.cat([ar_emb, rec_scal_at_atom, atom_scal], -1),
                                     batch.atom_mask, det, gen)
                s_ra, c_ra = scatter_mean_to_nodes(msg, batch.atom_res, batch.atom_mask, N)
                rec_atom = layer.finalize(None, s_ra, c_ra, batch.rec_mask, ura)
            lig_attr = pad_residual(lig_attr, lig_intra.shape[-1]) + lig_intra + lig_atom + lig_rec
            if not last:
                atom_attr = pad_residual(atom_attr, atom_intra.shape[-1]) + atom_intra + atom_lig + atom_rec
                rec_attr = pad_residual(rec_attr, rec_intra.shape[-1]) + rec_intra + rec_atom + rec_lig
        return self._heads(batch, lig_attr, sigmas, det, ura, gen)
