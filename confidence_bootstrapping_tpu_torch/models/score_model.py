"""SE(3)-equivariant tensor-product score model on padded complex batches.

Port of ``confidence_bootstrapping_tpu/models/score_model.py``, every
configuration the JAX package builds but ``sh_lmax >= 3``: lmax 1 or 2, the
lmax=1 or the second-order irreps ladder (``get_irrep_seq``), depthwise
layers, edge MLPs of any depth (``tp_weights_layers``) and the side-chain
head (``sidechain_pred``: an equivariant linear map of the receptor's final
features, its even and odd parts summed, ``ScoreOutput.sidechain_pred``). In
score mode:
atom encoders, receptor and ligand embedding convolutions, the 4-edge-group
trunk whose last layer updates the ligand only, the center convolution with
the translation and rotation heads, and the torsion head. Ligand radius
pairs are a dense masked [L, L] adjacency, cross edges are the nearest
``effective_cross_cap(N)`` receptor residues within 3 sigma_tr + 20,
receptor kNN lists come with the batch. The t-independent receptor embedding
is separate (``embed_receptor``) so the sampler computes it once.

At inference on the ladder route the ligand pairs and bonds take the pb
kernel (``conv_pb``) and both cross directions the cross_rev kernel
(``conv_cross_rev``) when their gates hold (L % 8 == 0, the cross list's
K % 16 == 0, as in the JAX package). Otherwise, on the general route (the
pairs on the edge-list kernel, ligand <- receptor on cross_g, the receptor
on rec_g), and in training (``deterministic=False``,
``use_running_average=False``), the JAX package's composition
(``score_model.py:326-350``, ``:447-477``) runs: the ligand pairs through
``conv_nbr`` and the bonds through ``messages``, the ligand <- receptor lists
through ``conv_cross`` and the receptor <- ligand ones through ``msgs_nbr``
and a scatter (``scatter_add_``: on the card its sums run in a
run-dependent order, as cross_rev's ``atomicAdd`` does). Training also embeds the receptor inside the forward and
applies dropout in the edge embeddings, the edge MLPs and the heads
(``score_model.py:504-584``). Parameters are frozen at construction
(inference); ``train.train_loop.init_train_state`` unfreezes them.

Confidence mode (``confidence_mode``): the batch's times are taken as the
sigmas (the confidence model sees poses at t=0), the cross lists are cut by
the ``crop_beyond`` mask (a fixed cutoff; in score mode 3 sigma_tr +
``crop_beyond``), and in place of the score heads the confidence heads
(``ConfidenceHead``, ``MaskedBatchNorm1d``) read the pooled ligand scalars,
as in the all-atom confidence model (``models/all_atom_model.py``), which
shares them (``add_confidence_heads``, ``confidence_heads``), and its score
heads (``add_score_heads``, ``score_heads``, ``torsion_head``).

``torsional_forward`` (``train --dataset torsional``): the ligand embedding
layers and the torsion head alone, on ligand-only batches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import ScoreModelConfig
from ..data.complex_graph import ComplexBatch
from ..data.vocab import LIG_FEATURE_DIMS, REC_RESIDUE_FEATURE_DIMS
from ..ops import so3, torus
from ..ops.graph_builders import gather_nodes, pairwise_dist, radius_mask, scatter_mean_to_nodes, topk_neighbors
from ..ops.irreps import FullTensorProduct, Irreps, spherical_harmonics, spherical_harmonics_irreps
from ..ops.schedules import get_timestep_embedding, t_to_sigma
from ..runtime import resolve_device
from .layers import AtomEncoder, FCBlock, GaussianSmearing, LinearIrreps, TPConv, dropout, pad_residual


def get_irrep_seq(ns: int, nv: int, reduce_pseudoscalars: bool, use_second_order_repr: bool = False):
    """The irreps ladder: lmax=1 blocks, or with ``use_second_order_repr``
    the second-order ladder, which adds l = 2 blocks."""
    last = nv if reduce_pseudoscalars else ns
    if use_second_order_repr:
        return [f"{ns}x0e", f"{ns}x0e + {nv}x1o + {nv}x2e", f"{ns}x0e + {nv}x1o + {nv}x2e + {nv}x1e + {nv}x2o",
                f"{ns}x0e + {nv}x1o + {nv}x2e + {nv}x1e + {nv}x2o + {last}x0o"]
    return [f"{ns}x0e", f"{ns}x0e + {nv}x1o", f"{ns}x0e + {nv}x1o + {nv}x1e", f"{ns}x0e + {nv}x1o + {nv}x1e + {last}x0o"]


SIDECHAIN_IRREPS = "4x0e + 2x1e + 4x0o + 2x1o"  # the side-chain head's even and odd parts, summed


class RecCache(NamedTuple):
    """t-independent receptor tensors, computed once per complex."""

    rec_attr: torch.Tensor  # [B, N, D] embedded receptor node features
    rec_edge_emb: torch.Tensor  # [B, N, KR, ns] embedded kNN edge features
    rec_edge_mask: torch.Tensor  # [B, N, KR]


class ScoreOutput(NamedTuple):
    tr_pred: torch.Tensor  # [B, 3]
    rot_pred: torch.Tensor  # [B, 3]
    tor_pred: torch.Tensor  # [B, R], zero on padded torsion slots
    sidechain_pred: Optional[torch.Tensor] = None  # [B, N, 10] with sidechain_pred: chi and backbone-vector predictions


class ConfidenceOutput(NamedTuple):
    confidence: torch.Tensor  # [B] (or [B, num_confidence_outputs (+ 1 with the affinity column)]; [B / P, P] with parallel P)
    atom_confidence: Optional[torch.Tensor] = None  # [B, L, atom_num_confidence_outputs]
    affinity: Optional[torch.Tensor] = None  # [B / parallel] with parallel > 1 (the legacy all-atom model)


class FinalNormMLP(nn.Module):
    """MLP rescaling the tr/rot vector norm: Linear Dropout ReLU Linear."""

    def __init__(self, in_dim: int, ns: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns), nn.Linear(ns, 1)])
        self.dropout = dropout

    def forward(self, norm, sigma_emb, deterministic: bool = True, generator=None):
        x = self.layers[0](torch.cat([norm, sigma_emb], dim=-1))
        return self.layers[1](torch.relu(dropout(x, self.dropout, deterministic, generator)))


class TorFinalMLP(nn.Module):
    """Bias-free tanh MLP for the torsion logits: Linear tanh Dropout Linear."""

    def __init__(self, in_dim: int, ns: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns, bias=False), nn.Linear(ns, 1, bias=False)])
        self.dropout = dropout

    def forward(self, x, deterministic: bool = True, generator=None):
        return self.layers[1](dropout(torch.tanh(self.layers[0](x)), self.dropout, deterministic, generator))


class TensorProductScoreModel(nn.Module):
    """Score model; built on ``device`` (default: the GPU) with weights drawn
    from ``seed``. Load trained weights with ``models.from_flax``."""

    def __init__(self, cfg: ScoreModelConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.sh_lmax > 2:
            raise NotImplementedError("the port's models take sh_lmax <= 2")
        self.cfg = c = cfg
        ns, nv = c.ns, c.nv
        sh = str(spherical_harmonics_irreps(c.sh_lmax))
        self.timestep_emb = get_timestep_embedding(c.embedding_type, c.sigma_embed_dim, c.embedding_scale)
        sig = c.sigma_embed_dim

        p = c.dropout
        self.lig_node_embedding = AtomEncoder(ns, LIG_FEATURE_DIMS, n_scalar=sig)
        self.lig_edge_embedding = FCBlock(c.in_lig_edge_features + sig + c.distance_embed_dim, ns, ns, dropout=p)
        self.rec_node_embedding = AtomEncoder(ns, REC_RESIDUE_FEATURE_DIMS, n_scalar=c.lm_embedding_dim)
        self.rec_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns, dropout=p)
        self.rec_sigma_embedding = FCBlock(sig, ns, ns, dropout=p)
        self.cross_edge_embedding = FCBlock(sig + c.cross_distance_embed_dim, ns, ns, dropout=p)
        self.lig_distance_expansion = GaussianSmearing(0.0, c.lig_max_radius, c.distance_embed_dim)
        self.rec_distance_expansion = GaussianSmearing(0.0, c.rec_max_radius, c.distance_embed_dim)
        self.cross_distance_expansion = GaussianSmearing(0.0, c.cross_max_distance, c.cross_distance_embed_dim)

        seq = get_irrep_seq(ns, nv, c.reduce_pseudoscalars, c.use_second_order_repr)
        P, C = c.num_prot_emb_layers, c.num_conv_layers

        def conv(i, groups):
            return TPConv(seq[min(i, 3)], sh, seq[min(i + 1, 3)], 3 * ns, num_groups=groups,
                          hidden_features=3 * ns, batch_norm=c.batch_norm, residual=True, dropout=p,
                          tp_weights_layers=c.tp_weights_layers, depthwise=c.depthwise_convolution)

        self.rec_emb_layers = nn.ModuleList(conv(i, 1) for i in range(P))
        self.lig_emb_layers = nn.ModuleList(conv(i, 1) for i in range(P))
        self.conv_layers = nn.ModuleList(
            conv(i, ((2 if i == P + C - 1 else 4) if c.differentiate_convolutions else 1)) for i in range(P, P + C)
        )
        self.final_irreps = seq[min(P + C, 3)]
        if c.sidechain_pred:
            self.sidechain_predictor = LinearIrreps(self.final_irreps, SIDECHAIN_IRREPS)

        if c.confidence_mode:
            add_confidence_heads(self, c)
        else:
            add_score_heads(self, c, sh)
        init_weights(self, seed)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    # ------------------------------------------------------------------ #
    # receptor embedding (t-independent)
    # ------------------------------------------------------------------ #

    def embed_receptor(self, batch: ComplexBatch, deterministic: bool = True, use_running_average: bool = True,
                       generator: Optional[torch.Generator] = None) -> RecCache:
        c = self.cfg
        det, gen = deterministic, generator
        rec_attr = self.rec_node_embedding(batch.rec_f[..., None], batch.rec_lm)
        vec = gather_nodes(batch.rec_pos, batch.rec_nbr) - batch.rec_pos[:, :, None, :]
        edge_emb = self.rec_edge_embedding(self.rec_distance_expansion(torch.linalg.norm(vec, dim=-1)), det, gen)
        emask = batch.rec_nbr_mask
        zero_sig = torch.zeros(rec_attr.shape[0], c.ns, dtype=rec_attr.dtype, device=rec_attr.device)
        for layer in self.rec_emb_layers:
            s, cnt = layer.conv_rec(0, rec_attr, batch.rec_pos, batch.rec_nbr, edge_emb, zero_sig, emask, det, gen)
            rec_attr = layer.finalize(rec_attr, s, cnt, batch.rec_mask, use_running_average)
        return RecCache(rec_attr=rec_attr, rec_edge_emb=edge_emb, rec_edge_mask=emask)

    # ------------------------------------------------------------------ #
    # ligand graph
    # ------------------------------------------------------------------ #

    def _lig_graph(self, batch: ComplexBatch, sigma_emb, deterministic: bool = True, generator=None) -> dict:
        """Embedded dense radius pairs (receiver i, sender j) and bond edges.
        Their harmonics, which only the composed route reads, are made by
        ``_lig_conv`` when it first needs them."""
        c = self.cfg
        det, gen = deterministic, generator
        pos = batch.lig_pos
        pair_mask, pair_d = radius_mask(pos, pos, c.lig_max_radius, batch.lig_mask, batch.lig_mask, exclude_self=True)
        zeros_bond = pair_d.new_zeros(pair_d.shape + (c.in_lig_edge_features,))
        se = sigma_emb[:, None, None, :].expand(pair_d.shape + (sigma_emb.shape[-1],))
        pair_emb = self.lig_edge_embedding(torch.cat([zeros_bond, se, self.lig_distance_expansion(pair_d)], dim=-1),
                                           det, gen)
        bvec = gather_nodes(pos, batch.lig_edge_dst) - gather_nodes(pos, batch.lig_edge_src)
        bd = torch.linalg.norm(bvec, dim=-1)
        se_b = sigma_emb[:, None, :].expand(bd.shape + (sigma_emb.shape[-1],))
        bond_emb = self.lig_edge_embedding(torch.cat([batch.lig_edge_attr, se_b, self.lig_distance_expansion(bd)],
                                                     dim=-1), det, gen)
        return dict(pair_mask=pair_mask, pair_emb=pair_emb, bond_emb=bond_emb)

    def _lig_conv(self, layer: TPConv, group: int, lig_attr, g: dict, batch: ComplexBatch, deterministic: bool = True,
                  generator=None):
        """Messages into ligand nodes from the ligand pairs and bonds (one
        edge MLP): (sums, counts). The pb kernel at inference when
        ``conv_pb`` applies; otherwise the pairs through ``conv_nbr`` and the
        bonds through ``messages``."""
        ns = self.cfg.ns
        if deterministic:
            fused = layer.conv_pb(group, lig_attr, batch.lig_pos, g["pair_emb"], g["pair_mask"], batch.lig_edge_src,
                                  batch.lig_edge_dst, g["bond_emb"], batch.lig_edge_mask, ns)
            if fused is not None:
                return fused
        if "pair_sh" not in g:
            pos = batch.lig_pos
            g["pair_sh"] = spherical_harmonics(self.cfg.sh_lmax, pos[:, None, :, :] - pos[:, :, None, :])
            g["bond_sh"] = spherical_harmonics(self.cfg.sh_lmax, gather_nodes(pos, batch.lig_edge_dst)
                                               - gather_nodes(pos, batch.lig_edge_src))
        scal = lig_attr[..., :ns]
        pe = g["pair_emb"]
        eattr = torch.cat([pe, scal[:, :, None, :].expand(pe.shape[:-1] + (ns,)),
                           scal[:, None, :, :].expand(pe.shape[:-1] + (ns,))], dim=-1)
        sender_pair = lig_attr[:, None, :, :].expand(eattr.shape[:-1] + (lig_attr.shape[-1],))
        sum_pair, cnt_pair = layer.conv_nbr(group, sender_pair, g["pair_sh"], eattr, g["pair_mask"], deterministic,
                                            generator)
        src, dst = batch.lig_edge_src, batch.lig_edge_dst
        eattr_b = torch.cat([g["bond_emb"], gather_nodes(scal, src), gather_nodes(scal, dst)], dim=-1)
        msg_b = layer.messages(group, gather_nodes(lig_attr, dst), g["bond_sh"], eattr_b, batch.lig_edge_mask,
                               deterministic, generator)
        sum_b, cnt_b = scatter_mean_to_nodes(msg_b, src, batch.lig_edge_mask, lig_attr.shape[1])
        return sum_pair + sum_b, cnt_pair + cnt_b

    # ------------------------------------------------------------------ #
    # forward
    # ------------------------------------------------------------------ #

    def forward(self, batch: ComplexBatch, rec_cache: Optional[RecCache] = None, deterministic: bool = True,
                use_running_average: bool = True, generator: Optional[torch.Generator] = None):
        """Scores of the batch's poses (``ScoreOutput``), or in confidence
        mode their confidences (``ConfidenceOutput``).
        ``deterministic=False``: the training composition with dropout drawn
        from ``generator``; ``use_running_average=False``: batch-norm
        statistics of the batch (the running ones move toward them)."""
        c = self.cfg
        ns = c.ns
        det, ura, gen = deterministic, use_running_average, generator
        B, L, _ = batch.lig_pos.shape
        N = batch.rec_pos.shape[1]
        if c.confidence_mode:  # the confidence model takes the times as the sigmas
            tr_sigma, rot_sigma, tor_sigma = batch.t_tr, batch.t_rot, batch.t_tor
        else:
            tr_sigma, rot_sigma, tor_sigma = t_to_sigma(batch.t_tr, batch.t_rot, batch.t_tor, c.sigma)
        sigma_emb = self.timestep_emb(batch.t_tr)

        if rec_cache is None:
            rec_cache = self.embed_receptor(batch, det, ura, gen)
        rec_sig = self.rec_sigma_embedding(sigma_emb, det, gen)
        rec_attr = rec_cache.rec_attr
        rec_attr = torch.cat([rec_attr[..., :ns] + rec_sig[:, None, :], rec_attr[..., ns:]], dim=-1)

        lig_attr = self.lig_node_embedding(batch.lig_f, sigma_emb[:, None, :].expand(B, L, sigma_emb.shape[-1]))
        graph = self._lig_graph(batch, sigma_emb, det, gen)
        for layer in self.lig_emb_layers:
            s, n = self._lig_conv(layer, 0, lig_attr, graph, batch, det, gen)
            lig_attr = layer.finalize(lig_attr, s, n, batch.lig_mask, ura)

        cutoff = (tr_sigma * 3 + 20)[:, None, None] if c.dynamic_max_cross else c.cross_max_distance
        rec_mask_eff = batch.rec_mask
        if c.crop_beyond is not None:  # receptor residues beyond the crop distance of every ligand atom leave the lists
            big = torch.tensor(1e9, device=batch.lig_pos.device)
            d_lr = torch.where(batch.lig_mask[:, :, None], pairwise_dist(batch.lig_pos, batch.rec_pos), big).amin(dim=1)
            crop_cut = c.crop_beyond if c.confidence_mode else (tr_sigma * 3 + c.crop_beyond)[:, None]
            rec_mask_eff = batch.rec_mask & (d_lr < crop_cut)
        cr_idx, cr_mask, cr_d = topk_neighbors(batch.lig_pos, batch.rec_pos, cutoff, batch.lig_mask, rec_mask_eff,
                                               c.effective_cross_cap(N))
        se_c = sigma_emb[:, None, None, :].expand(cr_d.shape + (sigma_emb.shape[-1],))
        cr_emb = self.cross_edge_embedding(torch.cat([se_c, self.cross_distance_expansion(cr_d)], dim=-1), det, gen)
        cr_sh_rev = None  # the composed receptor <- ligand route's harmonics, made when it first runs

        n_layers = len(self.conv_layers)
        for li, layer in enumerate(self.conv_layers):
            last = li == n_layers - 1
            if c.differentiate_convolutions:
                g_lig, g_lr, g_rec, g_rl = 0, 1, (None if last else 2), (None if last else 3)
            else:
                g_lig = g_lr = g_rec = 0
                g_rl = None if last else 0
            lig_sum, lig_cnt = self._lig_conv(layer, g_lig, lig_attr, graph, batch, det, gen)
            fused = layer.conv_cross_rev(g_lr, g_rl, lig_attr, batch.lig_pos, rec_attr, batch.rec_pos, cr_idx, cr_emb,
                                         cr_mask, ns) if det else None
            if fused is not None:
                s_lr, c_lr, s_rl, c_rl = fused
            else:
                s_lr, c_lr = layer.conv_cross(g_lr, lig_attr, batch.lig_pos, rec_attr, batch.rec_pos, cr_idx, cr_emb,
                                              cr_mask, ns, det, gen)
                s_rl = c_rl = None
            lig_sum, lig_cnt = lig_sum + s_lr, lig_cnt + c_lr
            if not last:
                rec_sum, rec_cnt = layer.conv_rec(g_rec, rec_attr, batch.rec_pos, batch.rec_nbr,
                                                  rec_cache.rec_edge_emb, rec_sig, rec_cache.rec_edge_mask, det, gen)
                if s_rl is None:  # receptor <- ligand over the reversed cross lists
                    if cr_sh_rev is None:
                        cr_sh_rev = spherical_harmonics(c.sh_lmax, batch.lig_pos[:, :, None, :]
                                                        - gather_nodes(batch.rec_pos, cr_idx))
                    D = lig_attr.shape[-1]
                    eattr_rl = torch.cat([cr_emb, gather_nodes(rec_attr, cr_idx)[..., :ns],
                                          lig_attr[:, :, None, :ns].expand(cr_emb.shape[:-1] + (ns,))], dim=-1)
                    msg_rl = layer.msgs_nbr(g_rl, lig_attr[:, :, None, :].expand(cr_emb.shape[:-1] + (D,)), cr_sh_rev,
                                            eattr_rl, cr_mask, det, gen)
                    s_rl, c_rl = scatter_mean_to_nodes(msg_rl.reshape(B, -1, msg_rl.shape[-1]), cr_idx.reshape(B, -1),
                                                       cr_mask.reshape(B, -1), N)
                new_lig = layer.finalize(lig_attr, lig_sum, lig_cnt, batch.lig_mask, ura)
                rec_attr = layer.finalize(rec_attr, rec_sum + s_rl, rec_cnt + c_rl, batch.rec_mask, ura)
                lig_attr = new_lig
            else:
                lig_attr = layer.finalize(lig_attr, lig_sum, lig_cnt, batch.lig_mask, ura)

        if c.confidence_mode:
            return confidence_heads(self, lig_attr, batch.lig_mask, det, ura, gen)

        sidechain = None
        if c.sidechain_pred:  # on the receptor's final features, widened to the trunk's last irreps
            sp = self.sidechain_predictor(pad_residual(rec_attr, Irreps(self.final_irreps).dim))
            sidechain = sp[..., :10] + sp[..., 10:]
        return ScoreOutput(*score_heads(self, batch, lig_attr, sigma_emb, tr_sigma, rot_sigma, tor_sigma, det, ura, gen),
                           sidechain_pred=sidechain)

    def torsional_forward(self, batch: ComplexBatch, deterministic: bool = True, use_running_average: bool = True,
                          generator: Optional[torch.Generator] = None):
        """Ligand-only torsion scores [B, R] (the ``--dataset torsional``
        pretraining mode, reference score_model.py:451-482): the ligand
        embedding layers (``_lig_conv``: at inference pb, or the composed
        pairs where L % 8 != 0; in training the edge-list op), the features
        widened to the torsion head's irreps, then the torsion head. The
        receptor is not read."""
        c = self.cfg
        det, ura, gen = deterministic, use_running_average, generator
        B, L, _ = batch.lig_pos.shape
        tor_sigma = t_to_sigma(batch.t_tor, batch.t_tor, batch.t_tor, c.sigma)[2]
        sigma_emb = self.timestep_emb(batch.t_tr)
        lig_attr = self.lig_node_embedding(batch.lig_f, sigma_emb[:, None, :].expand(B, L, sigma_emb.shape[-1]))
        graph = self._lig_graph(batch, sigma_emb, det, gen)
        for layer in self.lig_emb_layers:
            s, n = self._lig_conv(layer, 0, lig_attr, graph, batch, det, gen)
            lig_attr = layer.finalize(lig_attr, s, n, batch.lig_mask, ura)
        lig_attr = pad_residual(lig_attr, Irreps(self.final_irreps).dim)  # the ladder only appends blocks
        return torsion_head(self, batch, lig_attr, tor_sigma, det, ura, gen)


def add_score_heads(model: nn.Module, c: ScoreModelConfig, sh: str) -> None:
    """The score heads on ``model`` (whose ``final_irreps`` are the trunk's
    last): the center convolution, the translation and rotation norm MLPs
    and, unless ``no_torsion``, the torsion head. Shared by the residue-level
    and the all-atom models."""
    ns, sig, p = c.ns, c.sigma_embed_dim, c.dropout
    model.center_distance_expansion = GaussianSmearing(0.0, c.center_max_distance, c.distance_embed_dim)
    model.center_edge_embedding = FCBlock(c.distance_embed_dim + sig, ns, ns, dropout=p)
    model.final_conv = TPConv(model.final_irreps, sh, "2x1o + 2x1e" if not c.odd_parity else "1x1o + 1x1e",
                              2 * ns, batch_norm=c.batch_norm, residual=False, dropout=p)
    model.tr_final_layer = FinalNormMLP(1 + sig, ns, p)
    model.rot_final_layer = FinalNormMLP(1 + sig, ns, p)
    if not c.no_torsion:
        model.final_edge_embedding = FCBlock(c.distance_embed_dim, ns, ns, dropout=p)
        model.final_tp_tor = FullTensorProduct(sh, "1x2e")
        tor_out = f"{ns}x0o + {ns}x0e" if not c.odd_parity else f"{ns}x0o"
        model.tor_bond_conv = TPConv(model.final_irreps, str(model.final_tp_tor.irreps_out), tor_out, 3 * ns,
                                     batch_norm=c.batch_norm, residual=False, dropout=p)
        model.tor_final_layer = TorFinalMLP(Irreps(tor_out).dim, ns, p)


def score_heads(model: nn.Module, batch: ComplexBatch, lig_attr, sigma_emb, tr_sigma, rot_sigma, tor_sigma,
                deterministic: bool = True, use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
    """(tr [B, 3], rot [B, 3], tor [B, R]) from the ligand's final features:
    the center convolution's translational and rotational pseudo-vectors,
    their norms rescaled by the norm MLPs (and by sigma with
    ``scale_by_sigma``), then the torsion head (zeros with ``no_torsion``)."""
    c = model.cfg
    ns = c.ns
    det, ura, gen = deterministic, use_running_average, generator
    B = lig_attr.shape[0]
    m = batch.lig_mask.to(lig_attr.dtype)[..., None]
    center = torch.sum(batch.lig_pos * m, dim=1, keepdim=True) / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    cvec = batch.lig_pos - center
    cd = torch.linalg.norm(cvec, dim=-1)
    csh = spherical_harmonics(c.sh_lmax, cvec)
    se_l = sigma_emb[:, None, :].expand(cd.shape + (sigma_emb.shape[-1],))
    cattr = model.center_edge_embedding(torch.cat([model.center_distance_expansion(cd), se_l], dim=-1), det, gen)
    cattr = torch.cat([cattr, lig_attr[..., :ns]], dim=-1)
    msg_c = model.final_conv.messages(0, lig_attr, csh, cattr, batch.lig_mask, det, gen)
    cnt_c = torch.sum(batch.lig_mask, dim=1).to(msg_c.dtype)
    global_pred = model.final_conv.finalize(None, msg_c.sum(dim=1), cnt_c,
                                            torch.ones(B, dtype=torch.bool, device=msg_c.device), ura)
    if c.odd_parity:
        tr_pred, rot_pred = global_pred[:, :3], global_pred[:, 3:6]
    else:
        tr_pred = global_pred[:, :3] + global_pred[:, 6:9]
        rot_pred = global_pred[:, 3:6] + global_pred[:, 9:12]
    tr_norm = torch.linalg.norm(tr_pred, dim=1, keepdim=True)
    tr_pred = tr_pred / (tr_norm + 1e-12) * model.tr_final_layer(tr_norm, sigma_emb, det, gen)
    rot_norm = torch.linalg.norm(rot_pred, dim=1, keepdim=True)
    rot_pred = rot_pred / (rot_norm + 1e-12) * model.rot_final_layer(rot_norm, sigma_emb, det, gen)
    if c.scale_by_sigma:
        tr_pred = tr_pred / tr_sigma[:, None]
        rot_pred = rot_pred * so3.score_norm(rot_sigma)[:, None]
    if c.no_torsion:
        return tr_pred, rot_pred, tr_pred.new_zeros(B, batch.tor_src.shape[1])
    return tr_pred, rot_pred, torsion_head(model, batch, lig_attr, tor_sigma, det, ura, gen)


def torsion_head(model: nn.Module, batch: ComplexBatch, lig_attr, tor_sigma, deterministic: bool = True,
                 use_running_average: bool = True, generator: Optional[torch.Generator] = None):
    """The bond-centred torsion head: each rotatable bond's centre convolves
    the ligand atoms within ``lig_max_radius`` (harmonics of the atom offset
    times the bond's l=2 harmonics), then the bias-free MLP -> [B, R]
    scores, zero on padded torsion slots."""
    c = model.cfg
    ns = c.ns
    det, ura, gen = deterministic, use_running_average, generator
    pu = gather_nodes(batch.lig_pos, batch.tor_src)
    pv = gather_nodes(batch.lig_pos, batch.tor_dst)
    bond_pos, bond_vec = (pu + pv) / 2, pv - pu
    tb_mask, tb_d = radius_mask(bond_pos, batch.lig_pos, c.lig_max_radius, batch.tor_mask, batch.lig_mask)
    tb_vec = batch.lig_pos[:, None, :, :] - bond_pos[:, :, None, :]
    tb_sh0 = spherical_harmonics(c.sh_lmax, tb_vec)
    bond_sh2 = spherical_harmonics(2, bond_vec)[..., 4:]  # the l=2 block
    tb_sh = model.final_tp_tor(tb_sh0, bond_sh2[:, :, None, :].expand(tb_sh0.shape[:-1] + (5,)))
    tb_emb = model.final_edge_embedding(model.lig_distance_expansion(tb_d), det, gen)
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
    msg_t = model.tor_bond_conv.messages(0, sender_t, tb_sh, eattr_t, tb_mask, det, gen)
    tor_feat = model.tor_bond_conv.finalize(None, msg_t.sum(dim=2), tb_mask.sum(dim=2).to(msg_t.dtype),
                                            batch.tor_mask, ura)
    tor_pred = model.tor_final_layer(tor_feat, det, gen)[..., 0]
    if c.scale_by_sigma:
        tor_pred = tor_pred * torch.sqrt(torus.score_norm(tor_sigma))[:, None]
    return torch.where(batch.tor_mask, tor_pred, torch.zeros_like(tor_pred))


class MaskedBatchNorm1d(nn.Module):
    """Plain batch norm over the last axis: (x - mean) / sqrt(var + eps) *
    scale + bias. With ``use_running_average`` the running statistics;
    otherwise the statistics of the batch over every leading axis, over the
    rows ``mask`` keeps (biased variance), which the running ones then move
    toward with ``momentum``."""

    def __init__(self, dim: int, epsilon: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, mask=None, use_running_average: bool = True):
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            m = (torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device) if mask is None else mask).to(x.dtype)
            m = m[..., None]
            axes = tuple(range(x.ndim - 1))
            denom = torch.clamp(m.sum(), min=1.0)
            mean = torch.sum(x * m, dim=axes) / denom
            var = torch.sum((x - mean) ** 2 * m, dim=axes) / denom
            with torch.no_grad():
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean.detach())
                self.var.mul_(1 - self.momentum).add_(self.momentum * var.detach())
        return (x - mean) / torch.sqrt(var + self.epsilon) * self.scale + self.bias


class ConfidenceHead(nn.Module):
    """(Linear, batch norm, ReLU, Dropout) x 2, then Linear: the confidence
    predictor. ``mask`` selects the rows the batch statistics are taken
    over (the atom head's real ligand atoms); dropout at rate ``dropout``
    when not ``deterministic``, drawn from ``generator``."""

    def __init__(self, in_dim: int, ns: int, out_dim: int, use_batchnorm: bool = True, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns), nn.Linear(ns, ns), nn.Linear(ns, out_dim)])
        self.norms = nn.ModuleList(MaskedBatchNorm1d(ns) for _ in range(2)) if use_batchnorm else None
        self.dropout = dropout

    def forward(self, x, mask=None, deterministic: bool = True, use_running_average: bool = True,
                generator: Optional[torch.Generator] = None):
        for i in range(2):
            x = self.layers[i](x)
            if self.norms is not None:
                x = self.norms[i](x, mask, use_running_average)
            x = dropout(torch.relu(x), self.dropout, deterministic, generator)
        return self.layers[2](x)


def affinity_column(c: ScoreModelConfig) -> bool:
    """Whether the pose head carries the affinity as its last column: the
    residue-level model with ``affinity_prediction`` (the all-atom model has
    no such column, as in the JAX package)."""
    return c.affinity_prediction and not c.all_atoms


def add_confidence_heads(model: nn.Module, c: ScoreModelConfig) -> None:
    """The confidence model's heads on ``model``: with ``atom_confidence`` a
    per-atom head whose last ns outputs feed the pose head, then the pose
    head (``confidence_dropout`` in both; one more output for the affinity
    column, ``affinity_column``)."""
    ns = c.ns
    head_in = ns + (c.nv if c.reduce_pseudoscalars else ns) if c.num_prot_emb_layers + c.num_conv_layers >= 3 else ns
    bn = not c.confidence_no_batchnorm
    if c.atom_confidence:
        model.atom_confidence_predictor = ConfidenceHead(head_in, ns, c.atom_num_confidence_outputs + ns, bn,
                                                         c.confidence_dropout)
        head_in = ns
    model.confidence_predictor = ConfidenceHead(head_in, ns, c.num_confidence_outputs + int(affinity_column(c)), bn,
                                                c.confidence_dropout)


def confidence_heads(model: nn.Module, lig_attr, lig_mask, deterministic: bool = True,
                     use_running_average: bool = True, generator: Optional[torch.Generator] = None) -> ConfidenceOutput:
    """The heads ``add_confidence_heads`` made, on the ligand's final
    features: the per-atom head on the ligand scalars [lig[:ns] | lig[-last:]]
    (its batch statistics over the real atoms, ``lig_mask``), then the pose
    head on their masked mean."""
    c = model.cfg
    ns = c.ns
    if c.num_conv_layers + c.num_prot_emb_layers >= 3:
        scal = torch.cat([lig_attr[..., :ns], lig_attr[..., -(c.nv if c.reduce_pseudoscalars else ns):]], dim=-1)
    else:
        scal = lig_attr[..., :ns]
    det, ura, gen = deterministic, use_running_average, generator
    atom_conf = None
    if c.atom_confidence:
        out = model.atom_confidence_predictor(scal, lig_mask, det, ura, gen)
        atom_conf, scal = out[..., : c.atom_num_confidence_outputs], out[..., c.atom_num_confidence_outputs:]
    m = lig_mask.to(scal.dtype)[..., None]
    pooled = torch.sum(scal * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
    conf = model.confidence_predictor(pooled, None, det, ura, gen)
    if c.num_confidence_outputs == 1 and not affinity_column(c):
        conf = conf[..., 0]
    return ConfidenceOutput(conf, atom_conf)


def init_weights(model: nn.Module, seed: int) -> None:
    """Random weights from ``seed`` (torch.Generator on the CPU, so the same
    seed gives the same model on every device): linear layers uniform in
    +-1/sqrt(fan_in), embeddings Xavier-uniform, the equivariant linear
    maps' weights standard normal (their biases zero), batch norm at
    identity."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, LinearIrreps):
            for k in mod.weight_names:
                getattr(mod, k).data = torch.randn(getattr(mod, k).shape, generator=gen)
        if isinstance(mod, nn.Linear):
            bound = mod.in_features ** -0.5
            mod.weight.data = (torch.rand(mod.weight.shape, generator=gen) * 2 - 1) * bound
            if mod.bias is not None:
                mod.bias.data = (torch.rand(mod.bias.shape, generator=gen) * 2 - 1) * bound
        elif isinstance(mod, nn.Embedding):
            bound = (6.0 / sum(mod.weight.shape)) ** 0.5
            mod.weight.data = (torch.rand(mod.weight.shape, generator=gen) * 2 - 1) * bound
