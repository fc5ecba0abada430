"""All-atom SE(3)-equivariant model (the pretrained confidence architecture,
and its score mode) and the per-pose receptor crop.

Port of ``confidence_bootstrapping_tpu/models/all_atom_model.py``. The
coarse-grained graph gains an ``atom`` node type, every receptor heavy atom:

* embedding phase (t-independent): residues and atoms convolve jointly over
  4 edge groups [rec <- rec kNN, rec <- atom (membership), atom <- atom kNN,
  atom <- rec];
* trunk: 9 edge groups [lig, lig <- rec, lig <- atom, rec, rec <- lig,
  rec <- atom, atom, atom <- lig, atom <- rec]; the last layer keeps the 3
  groups that update the ligand;
* in confidence mode the confidence head on the masked mean of the ligand's
  scalars; in score mode the residue-level model's score heads
  (``score_model.add_score_heads``: the center convolution, the tr/rot norm
  MLPs and the torsion head), the sigmas taken from the times and the crop
  cut at 3 sigma_tr + ``crop_beyond`` per pose.

At inference the kNN groups (rec, atom) go through ``TPConv.conv_rec`` and
the ligand's cross groups (lig <- rec, lig <- atom) through
``TPConv.conv_cross``: at lmax=2, or on the second-order ladder, the
``rec_g`` and ``cross_g`` kernels; at lmax=1 on the irreps ladder the rec and
row 4 (cross) kernels; every other group is plain PyTorch
(``TPConv.messages``), as the JAX package leaves it to XLA. In training (``deterministic=False``) the JAX package's training
routing: the kNN groups through ``fused_tpconv_rec_train`` (rec_g with the
hidden-layer dropout mask), every other group through ``fused_tpconv_train``
(the edge-list kernel), with dropout (``dropout`` in the edge embeddings and
the edge MLPs, ``confidence_dropout`` in the heads) drawn from the caller's
generator; ``use_running_average=False`` normalizes with the batch's
statistics (the atom head's over the real ligand atoms) and moves the running
ones. As in the JAX package, ``depthwise_convolution`` is not read by this
model.

``compact_crop`` reproduces the reference's subgraph crop per pose with fixed
shapes: residues farther than the crop distance from every ligand atom go
with their atoms, the rest are packed to the front of (n_res, n_atoms)
buckets, neighbour lists are remapped and edges to cropped senders masked;
a receptor cache embedded on the full receptor is compacted with them (the
``embed_full_receptor`` path of ``sampler.score_confidence``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import ScoreModelConfig
from ..data.complex_graph import ComplexBatch
from ..data.vocab import LIG_FEATURE_DIMS, REC_ATOM_FEATURE_DIMS, REC_RESIDUE_FEATURE_DIMS
from ..ops.graph_builders import gather_nodes, pairwise_dist, radius_mask, scatter_mean_to_nodes, topk_neighbors
from ..ops.irreps import spherical_harmonics, spherical_harmonics_irreps
from ..ops.schedules import get_timestep_embedding, t_to_sigma
from ..runtime import resolve_device
from .layers import AtomEncoder, FCBlock, GaussianSmearing, TPConv
from .score_model import ConfidenceOutput, ScoreOutput, add_confidence_heads, add_score_heads, confidence_heads, \
    get_irrep_seq, init_weights, score_heads


class AtomRecCache(NamedTuple):
    """t-independent receptor tensors of the all-atom model."""

    rec_attr: torch.Tensor  # [B, N, D]
    atom_attr: torch.Tensor  # [B, A, D]
    rec_edge_emb: torch.Tensor  # [B, N, KR, ns]
    atom_edge_emb: torch.Tensor  # [B, A, KA, ns]
    ar_edge_emb: torch.Tensor  # [B, A, ns] (atom -> its residue)
    ar_edge_sh: torch.Tensor  # [B, A, sh]


def _take(a, idx):
    """a [B, N, ...] rows idx [B, M] -> [B, M, ...]."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def _select_pack(keep, order_key, cap: int):
    """Pack up to ``cap`` kept rows to the front in their original order; on
    overflow the smallest ``order_key`` survive, the lower index first among
    equal keys (as ``lax.top_k`` orders them: a stable sort).

    Returns (sel [B, cap] original indices ascending, valid [B, cap], inv
    [B, N] new position of each old index, selected [B, N] rows that made it)."""
    B, N = keep.shape
    k = min(cap, N)
    neg_inf = torch.tensor(float("-inf"), dtype=order_key.dtype, device=order_key.device)
    idx = torch.sort(torch.where(keep, -order_key, neg_inf), dim=1, descending=True, stable=True).indices[:, :k]
    valid_by_rank = torch.gather(keep, 1, idx)
    idx_sorted = torch.sort(torch.where(valid_by_rank, idx, N), dim=1).values
    valid = idx_sorted < N
    sel = torch.clamp(idx_sorted, max=N - 1)
    scatter_to = torch.where(valid, sel, N)
    inv = torch.zeros(B, N + 1, dtype=torch.int64, device=keep.device)
    inv.scatter_(1, scatter_to, torch.arange(k, device=keep.device).expand(B, k).contiguous())
    selected = torch.zeros(B, N + 1, dtype=torch.bool, device=keep.device)
    selected.scatter_(1, scatter_to, torch.ones_like(valid))
    return sel, valid, inv[:, :N], selected[:, :N]


def compact_crop(batch: ComplexBatch, cache: Optional[AtomRecCache], crop_dist: float, n_res: int, n_atoms: int):
    """Crop and compact the receptor view of a batch for the trunk.

    Residues whose C-alpha is ``crop_dist`` or farther from every ligand atom
    are dropped with their atoms; the kept ones are packed into (n_res,
    n_atoms) buckets, the nearest first on overflow. Neighbour lists are not
    recomputed: indices are remapped and edges whose sender was cropped keep
    index 0 and a false mask. ``cache``, a receptor embedding of the full
    batch (or None), is compacted with it. Returns (batch, cache, stats) with
    stats kept_res and res_overflow (and kept_atoms, atom_overflow) per
    pose."""
    B, N = batch.rec_mask.shape
    bi = torch.arange(B, device=batch.rec_mask.device)[:, None, None]
    inf = torch.tensor(float("inf"), device=batch.lig_pos.device)
    d = torch.where(batch.lig_mask[:, :, None], pairwise_dist(batch.lig_pos, batch.rec_pos), inf).amin(dim=1)
    keep_res = batch.rec_mask & (d < crop_dist)
    sel_r, val_r, inv_r, selected_r = _select_pack(keep_res, d, n_res)
    nbr = _take(batch.rec_nbr, sel_r)
    rep = dict(
        rec_f=_take(batch.rec_f, sel_r), rec_lm=_take(batch.rec_lm, sel_r), rec_pos=_take(batch.rec_pos, sel_r),
        rec_mask=val_r, rec_nbr=inv_r[bi, nbr], rec_nbr_mask=_take(batch.rec_nbr_mask, sel_r) & selected_r[bi, nbr],
    )
    kept = keep_res.sum(1)
    stats = dict(kept_res=kept, res_overflow=torch.clamp(kept - sel_r.shape[1], min=0))
    cache_rep = {}
    if cache is not None:
        cache_rep.update(rec_attr=_take(cache.rec_attr, sel_r), rec_edge_emb=_take(cache.rec_edge_emb, sel_r))
    if batch.atom_f is not None and batch.atom_f.numel():
        b2 = bi[..., 0]
        keep_atom = batch.atom_mask & selected_r[b2, batch.atom_res]
        sel_a, val_a, inv_a, selected_a = _select_pack(keep_atom, d[b2, batch.atom_res], n_atoms)
        anbr = _take(batch.atom_nbr, sel_a)
        rep.update(
            atom_f=_take(batch.atom_f, sel_a), atom_pos=_take(batch.atom_pos, sel_a), atom_mask=val_a,
            atom_nbr=inv_a[bi, anbr], atom_nbr_mask=_take(batch.atom_nbr_mask, sel_a) & selected_a[bi, anbr],
            atom_res=inv_r[b2, _take(batch.atom_res, sel_a)],
        )
        kept = keep_atom.sum(1)
        stats.update(kept_atoms=kept, atom_overflow=torch.clamp(kept - sel_a.shape[1], min=0))
        if cache is not None:
            cache_rep.update(atom_attr=_take(cache.atom_attr, sel_a), atom_edge_emb=_take(cache.atom_edge_emb, sel_a),
                             ar_edge_emb=_take(cache.ar_edge_emb, sel_a), ar_edge_sh=_take(cache.ar_edge_sh, sel_a))
    return batch.replace(**rep), (cache._replace(**cache_rep) if cache is not None else None), stats


def crops(cfg: ScoreModelConfig, batch: ComplexBatch) -> bool:
    """Whether ``crop_to_caps`` crops this batch: an all-atom config that
    crops, and a receptor bucket larger than ``crop_res_cap``."""
    return (cfg.all_atoms and cfg.crop_beyond is not None and cfg.crop_res_cap > 0 and cfg.crop_atom_cap > 0
            and batch.atom_f is not None and batch.rec_pos.shape[1] > cfg.crop_res_cap)


def crop_to_caps(cfg: ScoreModelConfig, batch: ComplexBatch, cache: Optional[AtomRecCache] = None):
    """(batch, cache, cropped): where ``crops``, the batch cropped and
    compacted into the config's (crop_res_cap, crop_atom_cap) buckets
    (``compact_crop``, with ``cache`` where given), as the reference crops
    before every confidence forward; otherwise the batch and cache as they
    are."""
    if crops(cfg, batch):
        b, c, _ = compact_crop(batch, cache, float(cfg.crop_beyond), cfg.crop_res_cap, cfg.crop_atom_cap)
        return b, c, True
    return batch, cache, False


class AllAtomScoreModel(nn.Module):
    """The all-atom model in confidence or score mode; built on ``device``
    (default: the GPU) with weights drawn from ``seed``. Load trained weights
    with ``models.from_flax``."""

    def __init__(self, cfg: ScoreModelConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.sh_lmax > 2:
            raise NotImplementedError("the port's models take sh_lmax <= 2")
        self.cfg = c = cfg
        ns, nv = c.ns, c.nv
        sh = str(spherical_harmonics_irreps(c.sh_lmax))
        sig = c.sigma_embed_dim
        self.timestep_emb = get_timestep_embedding(c.embedding_type, sig, c.embedding_scale)

        p = c.dropout
        self.lig_node_embedding = AtomEncoder(ns, LIG_FEATURE_DIMS, n_scalar=sig)
        self.lig_edge_embedding = FCBlock(c.in_lig_edge_features + sig + c.distance_embed_dim, ns, ns, dropout=p)
        self.rec_node_embedding = AtomEncoder(ns, REC_RESIDUE_FEATURE_DIMS, n_scalar=c.lm_embedding_dim)
        self.rec_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns, dropout=p)
        self.rec_sigma_embedding = FCBlock(sig, ns, ns, dropout=p)
        self.atom_node_embedding = AtomEncoder(ns, REC_ATOM_FEATURE_DIMS)
        self.atom_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns, dropout=p)
        self.lr_edge_embedding = FCBlock(sig + c.cross_distance_embed_dim, ns, ns, dropout=p)
        self.ar_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns, dropout=p)
        self.la_edge_embedding = FCBlock(sig + c.distance_embed_dim, ns, ns, dropout=p)
        self.lig_distance_expansion = GaussianSmearing(0.0, c.lig_max_radius, c.distance_embed_dim)
        self.rec_distance_expansion = GaussianSmearing(0.0, c.rec_max_radius, c.distance_embed_dim)
        self.cross_distance_expansion = GaussianSmearing(0.0, c.cross_max_distance, c.cross_distance_embed_dim)

        seq = get_irrep_seq(ns, nv, c.reduce_pseudoscalars, c.use_second_order_repr)
        P, C = c.num_prot_emb_layers, c.num_conv_layers
        if not c.embed_also_ligand and P > 0:
            raise NotImplementedError("embed_also_ligand=False requires num_prot_emb_layers=0")

        def conv(i, groups):
            return TPConv(seq[min(i, 3)], sh, seq[min(i + 1, 3)], 3 * ns, num_groups=groups,
                          hidden_features=3 * ns, batch_norm=c.batch_norm, residual=True, dropout=p,
                          tp_weights_layers=c.tp_weights_layers)

        groups = (lambda g: g) if c.differentiate_convolutions else (lambda g: 1)
        self.rec_emb_layers = nn.ModuleList(conv(i, groups(4)) for i in range(P))
        self.lig_emb_layers = nn.ModuleList(conv(i, 1) for i in range(P) if c.embed_also_ligand)
        self.conv_layers = nn.ModuleList(conv(i, groups(3 if i == P + C - 1 else 9)) for i in range(P, P + C))

        self.final_irreps = seq[min(P + C, 3)]
        if c.confidence_mode:
            add_confidence_heads(self, c)
        else:
            add_score_heads(self, c, sh)

        init_weights(self, seed)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def _groups(self, n: int):
        return tuple(range(n)) if self.cfg.differentiate_convolutions else (0,) * n

    # ------------------------------------------------------------------ #
    # receptor embedding (t-independent)
    # ------------------------------------------------------------------ #

    def embed_receptor(self, batch: ComplexBatch, deterministic: bool = True, use_running_average: bool = True,
                       generator: Optional[torch.Generator] = None) -> AtomRecCache:
        c = self.cfg
        ns = c.ns
        det, ura, gen = deterministic, use_running_average, generator
        rec_attr = self.rec_node_embedding(batch.rec_f[..., None], batch.rec_lm)
        atom_attr = self.atom_node_embedding(batch.atom_f)
        r_vec = gather_nodes(batch.rec_pos, batch.rec_nbr) - batch.rec_pos[:, :, None, :]
        rec_edge_emb = self.rec_edge_embedding(self.rec_distance_expansion(torch.linalg.norm(r_vec, dim=-1)), det, gen)
        a_vec = gather_nodes(batch.atom_pos, batch.atom_nbr) - batch.atom_pos[:, :, None, :]
        atom_edge_emb = self.atom_edge_embedding(self.lig_distance_expansion(torch.linalg.norm(a_vec, dim=-1)), det,
                                                 gen)
        ar_vec = gather_nodes(batch.rec_pos, batch.atom_res) - batch.atom_pos  # atom -> its residue
        ar_edge_emb = self.ar_edge_embedding(self.rec_distance_expansion(torch.linalg.norm(ar_vec, dim=-1)), det, gen)
        ar_edge_sh = spherical_harmonics(c.sh_lmax, ar_vec)
        ar_edge_sh_rev = spherical_harmonics(c.sh_lmax, -ar_vec)
        N = batch.rec_pos.shape[1]
        zero_sig = rec_attr.new_zeros(rec_attr.shape[0], ns)
        g = self._groups(4)
        for layer in self.rec_emb_layers:
            rec_scal, atom_scal = rec_attr[..., :ns], atom_attr[..., :ns]
            res_scal = gather_nodes(rec_scal, batch.atom_res)
            rec_sum, rec_cnt = layer.conv_rec(g[0], rec_attr, batch.rec_pos, batch.rec_nbr, rec_edge_emb, zero_sig,
                                              batch.rec_nbr_mask, det, gen)
            m1 = layer.messages(g[1], atom_attr, ar_edge_sh, torch.cat([ar_edge_emb, res_scal, atom_scal], -1),
                                batch.atom_mask, det, gen)
            s1, c1 = scatter_mean_to_nodes(m1, batch.atom_res, batch.atom_mask, N)
            atom_sum, atom_cnt = layer.conv_rec(g[2], atom_attr, batch.atom_pos, batch.atom_nbr, atom_edge_emb,
                                                zero_sig, batch.atom_nbr_mask, det, gen)
            m3 = layer.messages(g[3], gather_nodes(rec_attr, batch.atom_res), ar_edge_sh_rev,
                                torch.cat([ar_edge_emb, atom_scal, res_scal], -1), batch.atom_mask, det, gen)
            rec_attr = layer.finalize(rec_attr, rec_sum + s1, rec_cnt + c1, batch.rec_mask, ura)
            atom_attr = layer.finalize(atom_attr, atom_sum + m3, atom_cnt + batch.atom_mask.to(atom_cnt.dtype),
                                       batch.atom_mask, ura)
        return AtomRecCache(rec_attr, atom_attr, rec_edge_emb, atom_edge_emb, ar_edge_emb, ar_edge_sh)

    # ------------------------------------------------------------------ #
    # ligand graph (plain PyTorch at lmax=2: the pb kernel is lmax=1)
    # ------------------------------------------------------------------ #

    def _lig_graph(self, batch: ComplexBatch, sigma_emb, deterministic: bool = True, generator=None):
        c = self.cfg
        det, gen = deterministic, generator
        pos = batch.lig_pos
        pair_mask, pair_d = radius_mask(pos, pos, c.lig_max_radius, batch.lig_mask, batch.lig_mask, exclude_self=True)
        pair_sh = spherical_harmonics(c.sh_lmax, pos[:, None, :, :] - pos[:, :, None, :])
        se = sigma_emb[:, None, None, :].expand(pair_d.shape + (sigma_emb.shape[-1],))
        zeros_bond = pair_d.new_zeros(pair_d.shape + (c.in_lig_edge_features,))
        pair_emb = self.lig_edge_embedding(torch.cat([zeros_bond, se, self.lig_distance_expansion(pair_d)], dim=-1),
                                           det, gen)
        bvec = gather_nodes(pos, batch.lig_edge_dst) - gather_nodes(pos, batch.lig_edge_src)
        bd = torch.linalg.norm(bvec, dim=-1)
        se_b = sigma_emb[:, None, :].expand(bd.shape + (sigma_emb.shape[-1],))
        bond_emb = self.lig_edge_embedding(torch.cat([batch.lig_edge_attr, se_b, self.lig_distance_expansion(bd)], -1),
                                           det, gen)
        return dict(pair_mask=pair_mask, pair_sh=pair_sh, pair_emb=pair_emb,
                    bond_sh=spherical_harmonics(c.sh_lmax, bvec), bond_emb=bond_emb)

    def _lig_conv(self, layer: TPConv, group: int, lig_attr, g, batch: ComplexBatch, deterministic: bool = True,
                  generator=None):
        ns = self.cfg.ns
        scal = lig_attr[..., :ns]
        pe = g["pair_emb"]
        eattr = torch.cat([pe, scal[:, :, None, :].expand(pe.shape[:-1] + (ns,)),
                           scal[:, None, :, :].expand(pe.shape[:-1] + (ns,))], dim=-1)
        msg_pair = layer.messages(group, lig_attr[:, None, :, :], g["pair_sh"], eattr, g["pair_mask"], deterministic,
                                  generator)
        src, dst = batch.lig_edge_src, batch.lig_edge_dst
        eattr_b = torch.cat([g["bond_emb"], gather_nodes(scal, src), gather_nodes(scal, dst)], dim=-1)
        msg_b = layer.messages(group, gather_nodes(lig_attr, dst), g["bond_sh"], eattr_b, batch.lig_edge_mask,
                               deterministic, generator)
        sum_b, cnt_b = scatter_mean_to_nodes(msg_b, src, batch.lig_edge_mask, lig_attr.shape[1])
        return msg_pair.sum(dim=2) + sum_b, g["pair_mask"].sum(dim=2).to(sum_b.dtype) + cnt_b

    # ------------------------------------------------------------------ #
    # forward
    # ------------------------------------------------------------------ #

    def forward(self, batch: ComplexBatch, rec_cache: Optional[AtomRecCache] = None, deterministic: bool = True,
                use_running_average: bool = True, generator: Optional[torch.Generator] = None):
        """Confidences of the batch's poses (``ConfidenceOutput``), or in
        score mode their scores (``ScoreOutput``). ``deterministic=False``:
        the training routing with dropout drawn from ``generator``;
        ``use_running_average=False``: batch-norm statistics of the batch
        (the running ones move toward them)."""
        c = self.cfg
        ns = c.ns
        det, ura, gen = deterministic, use_running_average, generator
        B, L, _ = batch.lig_pos.shape
        N, A = batch.rec_pos.shape[1], batch.atom_pos.shape[1]
        if c.confidence_mode:  # the confidence model takes the times as the sigmas
            tr_sigma, rot_sigma, tor_sigma = batch.t_tr, batch.t_rot, batch.t_tor
        else:
            tr_sigma, rot_sigma, tor_sigma = t_to_sigma(batch.t_tr, batch.t_rot, batch.t_tor, c.sigma)
        sigma_emb = self.timestep_emb(batch.t_tr)

        if rec_cache is None:
            rec_cache = self.embed_receptor(batch, det, ura, gen)
        rec_sig = self.rec_sigma_embedding(sigma_emb, det, gen)

        def add_sig(x):
            return torch.cat([x[..., :ns] + rec_sig[:, None, :], x[..., ns:]], dim=-1)

        rec_attr, atom_attr = add_sig(rec_cache.rec_attr), add_sig(rec_cache.atom_attr)
        ar_edge_emb = rec_cache.ar_edge_emb + rec_sig[:, None, :]
        ar_edge_sh = rec_cache.ar_edge_sh
        ar_edge_sh_rev = spherical_harmonics(c.sh_lmax, batch.atom_pos - gather_nodes(batch.rec_pos, batch.atom_res))

        # crop mask: a fixed cutoff in confidence mode, 3 sigma_tr + crop_beyond a pose in score mode
        rec_mask_eff, atom_mask_eff = batch.rec_mask, batch.atom_mask
        if c.crop_beyond is not None:
            big = torch.tensor(1e9, device=batch.lig_pos.device)
            d_lr = torch.where(batch.lig_mask[:, :, None], pairwise_dist(batch.lig_pos, batch.rec_pos), big).amin(dim=1)
            cut = c.crop_beyond if c.confidence_mode else (tr_sigma * 3 + c.crop_beyond)[:, None]
            rec_mask_eff = batch.rec_mask & (d_lr < cut)
            atom_mask_eff = batch.atom_mask & torch.gather(rec_mask_eff, 1, batch.atom_res)

        lig_attr = self.lig_node_embedding(batch.lig_f, sigma_emb[:, None, :].expand(B, L, sigma_emb.shape[-1]))
        g = self._lig_graph(batch, sigma_emb, det, gen)
        for layer in self.lig_emb_layers:
            s, n = self._lig_conv(layer, 0, lig_attr, g, batch, det, gen)
            lig_attr = layer.finalize(lig_attr, s, n, batch.lig_mask, ura)

        # cross neighbour lists: lig <- rec within the dynamic cutoff, lig <- atom within lig_max_radius
        cutoff = (tr_sigma * 3 + 20)[:, None, None] if c.dynamic_max_cross else c.cross_max_distance
        lr_idx, lr_mask, lr_d = topk_neighbors(batch.lig_pos, batch.rec_pos, cutoff, batch.lig_mask, rec_mask_eff,
                                               c.effective_cross_cap(N))
        lr_sh_rev = spherical_harmonics(c.sh_lmax, batch.lig_pos[:, :, None, :] - gather_nodes(batch.rec_pos, lr_idx))
        se_c = sigma_emb[:, None, None, :].expand(lr_d.shape + (sigma_emb.shape[-1],))
        lr_emb = self.lr_edge_embedding(torch.cat([se_c, self.cross_distance_expansion(lr_d)], dim=-1), det, gen)
        la_idx, la_mask, la_d = topk_neighbors(batch.lig_pos, batch.atom_pos, c.lig_max_radius, batch.lig_mask,
                                               atom_mask_eff, min(A, c.atom_cross_cap))
        la_sh_rev = spherical_harmonics(c.sh_lmax, batch.lig_pos[:, :, None, :] - gather_nodes(batch.atom_pos, la_idx))
        se_a = sigma_emb[:, None, None, :].expand(la_d.shape + (sigma_emb.shape[-1],))
        la_emb = self.la_edge_embedding(torch.cat([se_a, self.lig_distance_expansion(la_d)], dim=-1), det, gen)

        G = dict(zip(("lig", "lr", "la", "rec", "rl", "ra", "atom", "al", "ar"), self._groups(9)))
        n_layers = len(self.conv_layers)
        for li, layer in enumerate(self.conv_layers):
            lig_scal, rec_scal, atom_scal = lig_attr[..., :ns], rec_attr[..., :ns], atom_attr[..., :ns]
            # ligand receives: pairs and bonds, then the two cross groups (cross_g)
            lig_sum, lig_cnt = self._lig_conv(layer, G["lig"], lig_attr, g, batch, det, gen)
            for grp, src, spos, idx, emb, mask in (("lr", rec_attr, batch.rec_pos, lr_idx, lr_emb, lr_mask),
                                                   ("la", atom_attr, batch.atom_pos, la_idx, la_emb, la_mask)):
                s_, c_ = layer.conv_cross(G[grp], lig_attr, batch.lig_pos, src, spos, idx, emb, mask, ns, det, gen)
                lig_sum, lig_cnt = lig_sum + s_, lig_cnt + c_
            if li == n_layers - 1:
                lig_attr = layer.finalize(lig_attr, lig_sum, lig_cnt, batch.lig_mask, ura)
                continue

            res_scal = gather_nodes(rec_scal, batch.atom_res)
            # receptor receives: its kNN (rec_g), the reversed lr list, its atoms
            rec_sum, rec_cnt = layer.conv_rec(G["rec"], rec_attr, batch.rec_pos, batch.rec_nbr,
                                              rec_cache.rec_edge_emb, rec_sig, batch.rec_nbr_mask, det, gen)
            s_, c_ = self._reverse_cross(layer, G["rl"], lig_attr, rec_attr, lr_idx, lr_emb, lr_sh_rev, lr_mask, N,
                                         det, gen)
            rec_sum, rec_cnt = rec_sum + s_, rec_cnt + c_
            m_ra = layer.messages(G["ra"], atom_attr, ar_edge_sh, torch.cat([ar_edge_emb, res_scal, atom_scal], -1),
                                  atom_mask_eff, det, gen)
            s_, c_ = scatter_mean_to_nodes(m_ra, batch.atom_res, atom_mask_eff, N)
            rec_sum, rec_cnt = rec_sum + s_, rec_cnt + c_

            # atoms receive: their kNN (rec_g), the reversed la list, their residue
            atom_sum, atom_cnt = layer.conv_rec(G["atom"], atom_attr, batch.atom_pos, batch.atom_nbr,
                                                rec_cache.atom_edge_emb, rec_sig, batch.atom_nbr_mask, det, gen)
            s_, c_ = self._reverse_cross(layer, G["al"], lig_attr, atom_attr, la_idx, la_emb, la_sh_rev, la_mask, A,
                                         det, gen)
            atom_sum, atom_cnt = atom_sum + s_, atom_cnt + c_
            m_ar = layer.messages(G["ar"], gather_nodes(rec_attr, batch.atom_res), ar_edge_sh_rev,
                                  torch.cat([ar_edge_emb, atom_scal, res_scal], -1), atom_mask_eff, det, gen)
            atom_sum, atom_cnt = atom_sum + m_ar, atom_cnt + atom_mask_eff.to(atom_cnt.dtype)

            lig_attr, rec_attr, atom_attr = (layer.finalize(lig_attr, lig_sum, lig_cnt, batch.lig_mask, ura),
                                             layer.finalize(rec_attr, rec_sum, rec_cnt, batch.rec_mask, ura),
                                             layer.finalize(atom_attr, atom_sum, atom_cnt, batch.atom_mask, ura))

        if c.confidence_mode:
            return confidence_heads(self, lig_attr, batch.lig_mask, det, ura, gen)
        return ScoreOutput(*score_heads(self, batch, lig_attr, sigma_emb, tr_sigma, rot_sigma, tor_sigma, det, ura,
                                        gen))

    @staticmethod
    def _reverse_cross(layer: TPConv, group: int, lig_attr, node_attr, idx, emb, sh_rev, mask, n_nodes: int,
                       deterministic: bool = True, generator=None):
        """node <- ligand messages over a capped ligand <- node list, scattered
        onto the nodes: (sums [B, n, out], counts [B, n])."""
        ns = emb.shape[-1]
        B = idx.shape[0]
        sender_scal = gather_nodes(node_attr[..., :ns], idx)
        lig_scal = lig_attr[:, :, None, :ns].expand(emb.shape[:-1] + (ns,))
        lig_bc = lig_attr[:, :, None, :].expand(emb.shape[:-1] + (lig_attr.shape[-1],))
        msg = layer.messages(group, lig_bc, sh_rev, torch.cat([emb, sender_scal, lig_scal], dim=-1), mask,
                             deterministic, generator)
        return scatter_mean_to_nodes(msg.reshape(B, -1, msg.shape[-1]), idx.reshape(B, -1), mask.reshape(B, -1),
                                     n_nodes)
