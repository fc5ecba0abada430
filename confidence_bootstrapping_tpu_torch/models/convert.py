"""Reference PyTorch checkpoints (e3nn state dicts) -> the Flax-layout tree
of the port's model directories.

Port of ``confidence_bootstrapping_tpu/models/convert.py``, numpy only. The
reference ships ``*.pt`` state dicts of four architectures: the score model
(``TensorProductScoreModel``), the all-atom confidence model
(``AAScoreModel``) and the two legacy ones (``OldCGScoreModel``,
``OldAAScoreModel``; ``models/legacy.py``). ``convert_state_dict`` maps one
to ``{"params": ..., "batch_stats": ...}`` in the Flax names and nesting the
JAX package's converter produces (the same tree, bit for bit, for the same
state dict); ``models.from_flax.load_flax_variables`` puts it into the
port's module, and ``train.checkpoints.save_params`` writes it as the JAX
package would. What the map does:

* a torch ``nn.Linear`` [out, in] becomes a Dense ``kernel`` [in, out];
  Linears inside a ``Sequential`` sit at indices 0, 3, 6, ... (FCBlock) or
  0, 4, 8 (the confidence heads, their ``BatchNorm1d`` at 1 and 5);
* e3nn's ``FullyConnectedTensorProduct`` lays its weights out instruction
  by instruction (input irrep major, harmonic, output irrep minor); the
  port's ``WeightedTensorProduct`` groups them by output irrep, so the last
  Dense of each edge MLP has its columns permuted
  (``e3nn_tp_weight_permutation``), with the torsion head's harmonics in
  e3nn's sorted order. The score models' trunk at sh_lmax=1 uses the
  reference's ``FasterTensorProduct``, whose layout is already the port's;
* e3nn ``BatchNorm`` keeps one running variance per irrep instance; the port
  splits it into ``var`` (0e) and ``norm`` (every other block);
* ``normalize_state_dict`` accepts the three layouts the reference writes: a
  raw ``state_dict``, a ``{epoch, model, optimizer, ema_weights}`` bundle and
  DataParallel's ``module.`` prefix.

Every layout assumption encodes e3nn 0.5.0, the version the reference pins.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..data.vocab import LIG_FEATURE_DIMS, REC_ATOM_FEATURE_DIMS, REC_RESIDUE_FEATURE_DIMS
from ..ops.irreps import FullTensorProduct, Irreps, WeightedTensorProduct, spherical_harmonics_irreps
from .legacy import LEGACY_AA_GROUPS
from .score_model import get_irrep_seq


def _seq(cfg, reduce_pseudoscalars: bool) -> list:
    return get_irrep_seq(cfg.ns, cfg.nv, reduce_pseudoscalars, cfg.use_second_order_repr)


def torch_linear(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch nn.Linear -> flax Dense params."""
    out = {"kernel": np.asarray(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def torch_fcblock(sd: Dict[str, Any], prefix: str, depth: int = 2,
                  out_perm: "np.ndarray | None" = None) -> Dict[str, Any]:
    """Reference FCBlock / Sequential(Linear, ReLU, Dropout, Linear) -> our
    FCBlock {Dense_0, Dense_1, ...}. The reference indexes layers inside a
    Sequential: Linear modules sit at indices 0, 3, 6, ....

    out_perm: optional permutation of the FINAL Dense's output units —
    our unit j reads the reference's unit out_perm[j]. Used to reorder
    e3nn TensorProduct weight columns into our grouped layout
    (see e3nn_tp_weight_permutation)."""
    out = {}
    for i in range(depth):
        out[f"Dense_{i}"] = torch_linear(sd, f"{prefix}.{3 * i}")
    if out_perm is not None:
        last = out[f"Dense_{depth - 1}"]
        last["kernel"] = last["kernel"][:, out_perm]
        if "bias" in last:
            last["bias"] = last["bias"][out_perm]
    return out


def e3nn_sorted_irreps(irreps) -> "list":
    """e3nn ``Irreps.sort().irreps.simplify()`` ordering: irreps sorted by
    the e3nn key (l, -p*(-1)^l) — 0e, 0o, 1o, 1e, 2e, 2o, ... — with equal
    irreps merged (e3nn o3/_irreps.py Irrep.__lt__). Returns
    [(mul, (l, p))]."""
    items = sorted(Irreps(irreps), key=lambda mi: (mi.ir.l, -mi.ir.p * (-1) ** mi.ir.l))
    merged: list = []
    for mul, ir in items:
        if merged and merged[-1][1] == (ir.l, ir.p):
            merged[-1][0] += mul
        else:
            merged.append([mul, (ir.l, ir.p)])
    return [(m, ir) for m, ir in merged]


def e3nn_sh_sort_order(sh_irreps) -> "list[int]":
    """Stable-sort order e3nn applies to tensor-product output irreps
    (o3 Irreps.sort: python `sorted` over (Irrep key, position) — STABLE,
    so duplicate (l, p) entries keep their relative order). order[k] = our
    path-order index of e3nn's k-th sh entry."""
    items = list(Irreps(sh_irreps))
    return sorted(range(len(items)),
                  key=lambda si: (items[si].ir.l, -items[si].ir.p * (-1) ** items[si].ir.l))


def e3nn_tp_weight_permutation(in_irreps, sh_irreps, out_irreps,
                               sh_sorted: bool = False) -> "np.ndarray | None":
    """Permutation taking e3nn's flat TP weight layout to ours.

    e3nn-0.5 ``o3.FullyConnectedTensorProduct(in, sh, out,
    shared_weights=False)`` (o3/_tensor_product/_sub.py) enumerates one
    'uvw' instruction per admissible (i_in, i_sh, i_out) triple with i_in
    MAJOR, i_sh middle, i_out MINOR, and flattens the weight buffer as the
    concatenation of per-instruction (mul_in, mul_sh, mul_out) blocks in C
    order. Our WeightedTensorProduct (ops/irreps.py) groups by OUTPUT irrep
    instead: per out irrep a [sum-of-mul_in, mul_out] block whose rows
    concatenate the (i_in major, i_sh minor) paths. Same weight count, same
    per-path normalization (e3nn 'component' irrep normalization +
    'element' path normalization = our sqrt(2l_out+1)-scaled CG and
    1/sqrt(fan) weight scale), DIFFERENT flat order.

    Returns perm with ours_flat = e3nn_flat[perm], or None when the layouts
    coincide. sh_sorted=True: the e3nn side sees the sh entries in e3nn's
    sorted order (the torsion head's FullTensorProduct(sh, '2e') output is
    sorted by e3nn; ours keeps path order) — matched via the stable sort
    order, which is exact even with duplicate (l, p) sh entries.
    """
    irr_in = Irreps(in_irreps)
    irr_sh = Irreps(sh_irreps)
    irr_out = Irreps(out_irreps)
    if any(m != 1 for m, _ in irr_sh):
        raise NotImplementedError("sh multiplicities must be 1")
    order = e3nn_sh_sort_order(irr_sh) if sh_sorted else list(range(len(irr_sh)))

    # e3nn flat layout: instruction offsets keyed by (i_in, ours_si, i_out)
    ofs_of = {}
    ofs = 0
    for i1, (mul1, ir1) in enumerate(irr_in):
        for si in order:  # e3nn's i_2 enumeration order
            _, ir2 = irr_sh[si]
            l2, p2 = ir2.l, ir2.p
            for io, (mulo, iro) in enumerate(irr_out):
                if abs(ir1.l - l2) <= iro.l <= ir1.l + l2 and ir1.p * p2 == iro.p:
                    ofs_of[(i1, si, io)] = ofs
                    ofs += mul1 * mulo

    tp = WeightedTensorProduct(irr_in, irr_sh, irr_out)
    if tp.weight_numel != ofs:
        raise ValueError(f"weight count mismatch: ours {tp.weight_numel} vs e3nn {ofs}")
    perm = np.empty(ofs, dtype=np.int64)
    w_ofs = 0
    for g in tp.groups:
        mulo = tp.irreps_out[g.out_index][0]
        row = 0
        for ii, si in g.paths:
            mul1 = irr_in[ii][0]
            blk = ofs_of[(ii, si, g.out_index)]
            for u in range(mul1):
                for v in range(mulo):
                    perm[w_ofs + (row + u) * mulo + v] = blk + u * mulo + v
            row += mul1
        w_ofs += g.w_shape[0] * g.w_shape[1]
    if np.array_equal(perm, np.arange(ofs)):
        return None
    return perm


def torch_atom_encoder(sd: Dict[str, Any], prefix: str, n_features: int) -> Dict[str, Any]:
    out = {}
    for i in range(n_features):
        out[f"Embed_{i}"] = {"embedding": np.asarray(sd[f"{prefix}.atom_embedding_list.{i}.weight"])}
    if f"{prefix}.additional_features_embedder.weight" in sd:
        out["Dense_0"] = torch_linear(sd, f"{prefix}.additional_features_embedder")
    return out


def torch_tpconv(sd: Dict[str, Any], prefix: str, irreps_out: str, n_groups: int = 1,
                 depth: int = 2, batch_norm: bool = True,
                 weight_perm: "np.ndarray | None" = None) -> "tuple[Dict, Dict]":
    """Reference TensorProductConvLayer -> our TPConv (params, batch_stats).

    fc (or fc.{g} with edge_groups) FCBlocks map Dense-for-Dense when the
    reference layer uses FasterTensorProduct (its grouped weight layout IS
    ours, see module docstring); layers built on the generic e3nn
    FullyConnectedTensorProduct pass ``weight_perm``
    (e3nn_tp_weight_permutation) to reorder the final Dense's columns from
    e3nn's instruction-major layout into our grouped layout. The e3nn
    BatchNorm running stats split into our (mean, var, norm) by irrep kind.
    """
    params: Dict[str, Any] = {}
    if n_groups == 1 and f"{prefix}.fc.0.weight" in sd:
        params["edge_mlps_0"] = torch_fcblock(sd, f"{prefix}.fc", depth, out_perm=weight_perm)
    else:
        for g in range(n_groups):
            params[f"edge_mlps_{g}"] = torch_fcblock(sd, f"{prefix}.fc.{g}", depth, out_perm=weight_perm)
    stats: Dict[str, Any] = {}
    if batch_norm and f"{prefix}.batch_norm.weight" in sd:
        bn_p, bn_s = torch_bn_irreps(sd, f"{prefix}.batch_norm", irreps_out)
        params["bn"] = bn_p
        stats["bn"] = bn_s
    return params, stats


def _irreps_str(items) -> str:
    return " + ".join(f"{m}x{l}{'e' if p > 0 else 'o'}" for m, (l, p) in items)


def tp_perm_for_layer(cfg, in_irreps, out_irreps, kind: str = "trunk",
                      force_generic: bool = False) -> "np.ndarray | None":
    """weight_perm for one reference TP conv layer, or None (layouts match).

    kind='trunk' layers use FasterTensorProduct when ``sh_lmax == 1 and not
    use_second_order_repr`` (reference models/score_model.py:146,
    all_atom_score_model.py:125) — that layout IS ours, no permutation.
    The 'final' and 'tor' head convs ALWAYS use the generic e3nn
    FullyConnectedTensorProduct (reference score_model.py:245,266), as do
    ALL layers of the legacy models (old_score_model.py:94) —
    force_generic=True. 'tor' layers take the FullTensorProduct(sh, '2e')
    spherical harmonics, which e3nn SORTS (ours keeps path order)."""
    c = cfg
    faster = c.sh_lmax == 1 and not c.use_second_order_repr and not force_generic
    if kind == "trunk" and faster:
        return None
    sh = str(spherical_harmonics_irreps(c.sh_lmax))
    if kind == "tor":
        sh_ours = str(FullTensorProduct(sh, "1x2e").irreps_out)
        return e3nn_tp_weight_permutation(in_irreps, sh_ours, out_irreps, sh_sorted=True)
    return e3nn_tp_weight_permutation(in_irreps, sh, out_irreps)


def torch_bn_irreps(sd: Dict[str, Any], prefix: str, irreps: str) -> "tuple[Dict, Dict]":
    """e3nn BatchNorm buffers -> BatchNormIrreps params + batch_stats.

    e3nn keeps running_mean over 0e features and running_var over every
    irrep instance (one per mul); ours splits running_var into `var` (0e)
    and `norm` (everything else, incl. 0o pseudoscalars) in irreps order.
    Per-mul affine weights and scalar biases map directly; no l=1 basis
    permutation is needed (all BN statistics are per-mul, component-free).
    """
    weight = np.asarray(sd[f"{prefix}.weight"])
    bias = np.asarray(sd[f"{prefix}.bias"])
    running_mean = np.asarray(sd[f"{prefix}.running_mean"])
    running_var = np.asarray(sd[f"{prefix}.running_var"])

    var_parts, norm_parts = [], []
    i = 0
    for mul, ir in Irreps(irreps):
        chunk = running_var[i : i + mul]
        (var_parts if (ir.l == 0 and ir.p == 1) else norm_parts).append(chunk)
        i += mul
    params = {"weight": weight, "bias": bias}
    stats = {
        "mean": running_mean,
        "var": np.concatenate(var_parts) if var_parts else np.zeros((0,), np.float32),
        "norm": np.concatenate(norm_parts) if norm_parts else np.zeros((0,), np.float32),
    }
    return params, stats


def torch_seq_mlp(sd: Dict[str, Any], prefix: str, linear_idx) -> Dict[str, Any]:
    """torch Sequential with Linears at the given indices -> {Dense_i}."""
    out = {}
    for j, idx in enumerate(linear_idx):
        out[f"Dense_{j}"] = torch_linear(sd, f"{prefix}.{idx}")
    return out


def torch_confidence_head(sd: Dict[str, Any], prefix: str, batch_norm: bool = True) -> "tuple[Dict, Dict]":
    """Reference confidence_predictor Sequential (Linear@0, BN1d@1, ReLU,
    Dropout, Linear@4, BN1d@5, ReLU, Dropout, Linear@8) -> ConfidenceHead."""
    params = torch_seq_mlp(sd, prefix, (0, 4, 8))
    stats: Dict[str, Any] = {}
    if batch_norm and f"{prefix}.1.weight" in sd:
        for j, idx in enumerate((1, 5)):
            params[f"MaskedBatchNorm1d_{j}"] = {
                "scale": np.asarray(sd[f"{prefix}.{idx}.weight"]),
                "bias": np.asarray(sd[f"{prefix}.{idx}.bias"]),
            }
            stats[f"MaskedBatchNorm1d_{j}"] = {
                "mean": np.asarray(sd[f"{prefix}.{idx}.running_mean"]),
                "var": np.asarray(sd[f"{prefix}.{idx}.running_var"]),
            }
    return params, stats


def convert_score_model(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Full reference ``TensorProductScoreModel`` state dict -> flax
    variables {params, batch_stats} for our model (score or confidence
    mode; coarse-grained architecture, models/score_model.py).

    Raises KeyError when an expected reference key is missing — run against
    a state dict saved from the reference repo (``model.state_dict()`` of
    ``utils/utils.py:get_model``'s module).
    """
    c = cfg
    seq = _seq(c, c.reduce_pseudoscalars)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["lig_node_embedding"] = torch_atom_encoder(sd, "lig_node_embedding", len(LIG_FEATURE_DIMS))
    params["rec_node_embedding"] = torch_atom_encoder(sd, "rec_node_embedding", len(REC_RESIDUE_FEATURE_DIMS))
    for name in ("lig_edge_embedding", "rec_edge_embedding", "rec_sigma_embedding", "cross_edge_embedding"):
        params[name] = torch_fcblock(sd, name)

    def add_tpconv(our_name, ref_prefix, in_irreps, irreps_out, n_groups=1, kind="trunk"):
        p, s = torch_tpconv(sd, ref_prefix, irreps_out, n_groups,
                            depth=c.tp_weights_layers, batch_norm=c.batch_norm,
                            weight_perm=tp_perm_for_layer(c, in_irreps, irreps_out, kind))
        params[our_name] = p
        if s:
            stats[our_name] = s

    for i in range(c.num_prot_emb_layers):
        add_tpconv(f"rec_emb_layers_{i}", f"rec_emb_layers.{i}", seq[min(i, 3)], seq[min(i + 1, 3)])
        if getattr(c, "embed_also_ligand", True):
            add_tpconv(f"lig_emb_layers_{i}", f"lig_emb_layers.{i}", seq[min(i, 3)], seq[min(i + 1, 3)])

    P, C = c.num_prot_emb_layers, c.num_conv_layers
    for k, i in enumerate(range(P, P + C)):
        last = i == P + C - 1
        groups = (2 if last else 4) if c.differentiate_convolutions else 1
        add_tpconv(f"conv_layers_{k}", f"conv_layers.{k}", seq[min(i, 3)], seq[min(i + 1, 3)], groups)

    if c.confidence_mode:
        p, s = torch_confidence_head(sd, "confidence_predictor", not c.confidence_no_batchnorm)
        params["confidence_predictor"] = p
        if s:
            stats["confidence_predictor"] = s
        if c.atom_confidence:
            p, s = torch_confidence_head(sd, "atom_confidence_predictor", not c.confidence_no_batchnorm)
            params["atom_confidence_predictor"] = p
            if s:
                stats["atom_confidence_predictor"] = s
    else:
        trunk_out = seq[min(P + C, 3)]
        params["center_edge_embedding"] = torch_fcblock(sd, "center_edge_embedding")
        add_tpconv("final_conv", "final_conv", trunk_out,
                   "2x1o + 2x1e" if not c.odd_parity else "1x1o + 1x1e", kind="final")
        params["tr_final_layer"] = torch_seq_mlp(sd, "tr_final_layer", (0, 3))
        params["rot_final_layer"] = torch_seq_mlp(sd, "rot_final_layer", (0, 3))
        if not c.no_torsion:
            params["final_edge_embedding"] = torch_fcblock(sd, "final_edge_embedding")
            add_tpconv("tor_bond_conv", "tor_bond_conv", trunk_out,
                       f"{c.ns}x0o + {c.ns}x0e" if not c.odd_parity else f"{c.ns}x0o", kind="tor")
            params["tor_final_layer"] = torch_seq_mlp(sd, "tor_final_layer", (0, 3))

    return {"params": params, "batch_stats": stats}


def convert_all_atom_model(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Reference ``AAScoreModel`` (models/all_atom_score_model.py) state dict
    -> flax variables for our AllAtomScoreModel — the pretrained confidence
    architecture. Separate ``affinity_predictor`` modules are not mapped
    (the all-atom model has no affinity head)."""
    c = cfg
    seq = _seq(c, c.reduce_pseudoscalars)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["lig_node_embedding"] = torch_atom_encoder(sd, "lig_node_embedding", len(LIG_FEATURE_DIMS))
    params["rec_node_embedding"] = torch_atom_encoder(sd, "rec_node_embedding", len(REC_RESIDUE_FEATURE_DIMS))
    params["atom_node_embedding"] = torch_atom_encoder(sd, "atom_node_embedding", len(REC_ATOM_FEATURE_DIMS))
    for name in ("lig_edge_embedding", "rec_edge_embedding", "rec_sigma_embedding",
                 "atom_edge_embedding", "lr_edge_embedding", "ar_edge_embedding", "la_edge_embedding"):
        params[name] = torch_fcblock(sd, name)

    def add_tpconv(our_name, ref_prefix, in_irreps, irreps_out, n_groups=1, kind="trunk"):
        p, s = torch_tpconv(sd, ref_prefix, irreps_out, n_groups,
                            depth=c.tp_weights_layers, batch_norm=c.batch_norm,
                            weight_perm=tp_perm_for_layer(c, in_irreps, irreps_out, kind))
        params[our_name] = p
        if s:
            stats[our_name] = s

    P, C = c.num_prot_emb_layers, c.num_conv_layers
    for i in range(P):
        add_tpconv(f"rec_emb_layers_{i}", f"rec_emb_layers.{i}", seq[min(i, 3)], seq[min(i + 1, 3)],
                   4 if c.differentiate_convolutions else 1)
        if getattr(c, "embed_also_ligand", True):
            add_tpconv(f"lig_emb_layers_{i}", f"lig_emb_layers.{i}", seq[min(i, 3)], seq[min(i + 1, 3)])
    for k, i in enumerate(range(P, P + C)):
        last = i == P + C - 1
        groups = ((3 if last else 9) if c.differentiate_convolutions else 1)
        add_tpconv(f"conv_layers_{k}", f"conv_layers.{k}", seq[min(i, 3)], seq[min(i + 1, 3)], groups)

    if c.confidence_mode:
        p, s = torch_confidence_head(sd, "confidence_predictor", not c.confidence_no_batchnorm)
        params["confidence_predictor"] = p
        if s:
            stats["confidence_predictor"] = s
        if c.atom_confidence:
            p, s = torch_confidence_head(sd, "atom_confidence_predictor", not c.confidence_no_batchnorm)
            params["atom_confidence_predictor"] = p
            if s:
                stats["atom_confidence_predictor"] = s
    else:
        trunk_out = seq[min(P + C, 3)]
        params["center_edge_embedding"] = torch_fcblock(sd, "center_edge_embedding")
        add_tpconv("final_conv", "final_conv", trunk_out,
                   "2x1o + 2x1e" if not c.odd_parity else "1x1o + 1x1e", kind="final")
        params["tr_final_layer"] = torch_seq_mlp(sd, "tr_final_layer", (0, 3))
        params["rot_final_layer"] = torch_seq_mlp(sd, "rot_final_layer", (0, 3))
        if not c.no_torsion:
            params["final_edge_embedding"] = torch_fcblock(sd, "final_edge_embedding")
            add_tpconv("tor_bond_conv", "tor_bond_conv", trunk_out,
                       f"{c.ns}x0o + {c.ns}x0e" if not c.odd_parity else f"{c.ns}x0o", kind="tor")
            params["tor_final_layer"] = torch_seq_mlp(sd, "tor_final_layer", (0, 3))

    return {"params": params, "batch_stats": stats}


def torch_old_atom_encoder(sd: Dict[str, Any], prefix: str, n_features: int) -> Dict[str, Any]:
    """Reference OldAtomEncoder (old_score_model.py:16-52) -> our
    OldAtomEncoder: the scalar-add ``linear`` maps to Dense_0, the optional
    ``lm_embedding_layer`` merge to Dense_1. The non-old AtomEncoder's
    single ``additional_features_embedder`` is handled by
    ``torch_atom_encoder`` (same flax layout: one Dense_0)."""
    out = {}
    for i in range(n_features):
        out[f"Embed_{i}"] = {"embedding": np.asarray(sd[f"{prefix}.atom_embedding_list.{i}.weight"])}
    if f"{prefix}.linear.weight" in sd:
        out["Dense_0"] = torch_linear(sd, f"{prefix}.linear")
    if f"{prefix}.lm_embedding_layer.weight" in sd:
        out["Dense_1"] = torch_linear(sd, f"{prefix}.lm_embedding_layer")
    return out


def _legacy_encoder(sd, prefix, n_features, use_old):
    return (torch_old_atom_encoder if use_old else torch_atom_encoder)(sd, prefix, n_features)


def _legacy_heads(sd, cfg, params, stats, add_tpconv, trunk_out):
    """Shared legacy head mapping (score heads or confidence/affinity heads;
    reference old_all_atom_score_model.py:117-198)."""
    c = cfg
    if c.confidence_mode:
        p, s = torch_confidence_head(sd, "confidence_predictor", not c.confidence_no_batchnorm)
        params["confidence_predictor"] = p
        if s:
            stats["confidence_predictor"] = s
        if getattr(c, "parallel", 1) > 1:
            p, s = torch_confidence_head(sd, "affinity_predictor", not c.confidence_no_batchnorm)
            params["affinity_predictor"] = p
            if s:
                stats["affinity_predictor"] = s
        return
    params["center_edge_embedding"] = torch_fcblock(sd, "center_edge_embedding")
    add_tpconv("final_conv", "final_conv", trunk_out,
               "2x1o + 2x1e" if not c.odd_parity else "1x1o + 1x1e", kind="final")
    params["tr_final_layer"] = torch_seq_mlp(sd, "tr_final_layer", (0, 3))
    params["rot_final_layer"] = torch_seq_mlp(sd, "rot_final_layer", (0, 3))
    if not c.no_torsion:
        params["final_edge_embedding"] = torch_fcblock(sd, "final_edge_embedding")
        add_tpconv("tor_bond_conv", "tor_bond_conv", trunk_out,
                   f"{c.ns}x0o + {c.ns}x0e" if not c.odd_parity else f"{c.ns}x0o", kind="tor")
        params["tor_final_layer"] = torch_seq_mlp(sd, "tor_final_layer", (0, 3))


def convert_legacy_score_model(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Reference ``OldCGScoreModel`` (models/old_score_model.py, the
    originally-published DiffDock checkpoints) -> flax variables for
    OldTensorProductScoreModel. Per-group conv lists map name-for-name
    (lig/rec/lig_to_rec/rec_to_lig_conv_layers.{i})."""
    c = cfg
    seq = _seq(c, False)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    old_enc = c.use_old_atom_encoder
    params["lig_node_embedding"] = _legacy_encoder(sd, "lig_node_embedding", len(LIG_FEATURE_DIMS), old_enc)
    params["rec_node_embedding"] = _legacy_encoder(sd, "rec_node_embedding", len(REC_RESIDUE_FEATURE_DIMS), old_enc)
    for name in ("lig_edge_embedding", "rec_edge_embedding", "cross_edge_embedding"):
        params[name] = torch_fcblock(sd, name)

    def add_tpconv(our_name, ref_prefix, in_irreps, irreps_out, kind="trunk"):
        # legacy layers ALWAYS use the generic e3nn TP (old_score_model.py:94)
        p, s = torch_tpconv(sd, ref_prefix, irreps_out, 1, depth=2, batch_norm=c.batch_norm,
                            weight_perm=tp_perm_for_layer(c, in_irreps, irreps_out, kind,
                                                          force_generic=True))
        params[our_name] = p
        if s:
            stats[our_name] = s

    n = c.num_conv_layers
    for i in range(n):
        in_ir, out_ir = seq[min(i, 3)], seq[min(i + 1, 3)]
        add_tpconv(f"lig_conv_layers_{i}", f"lig_conv_layers.{i}", in_ir, out_ir)
        add_tpconv(f"rec_to_lig_conv_layers_{i}", f"rec_to_lig_conv_layers.{i}", in_ir, out_ir)
        if i < n - 1:
            # the last depth's rec-side convs are allocated by the reference
            # but never used in forward (old_score_model.py last-layer
            # optimisation) — our model has no params for them
            add_tpconv(f"rec_conv_layers_{i}", f"rec_conv_layers.{i}", in_ir, out_ir)
            add_tpconv(f"lig_to_rec_conv_layers_{i}", f"lig_to_rec_conv_layers.{i}", in_ir, out_ir)

    _legacy_heads(sd, c, params, stats, add_tpconv, seq[min(n, 3)])
    return {"params": params, "batch_stats": stats}


def convert_legacy_all_atom_model(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Reference ``OldAAScoreModel`` (models/old_all_atom_score_model.py,
    the published confidence/affinity checkpoints) -> flax variables for
    OldAllAtomScoreModel. The reference keeps ONE flat ``conv_layers``
    ModuleList with 9 convs per depth; the last depth's trailing 6 are
    allocated but never used in forward (:246) — we skip them."""
    c = cfg
    seq = _seq(c, False)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    old_enc = c.use_old_atom_encoder
    params["lig_node_embedding"] = _legacy_encoder(sd, "lig_node_embedding", len(LIG_FEATURE_DIMS), old_enc)
    params["rec_node_embedding"] = _legacy_encoder(sd, "rec_node_embedding", len(REC_RESIDUE_FEATURE_DIMS), old_enc)
    params["atom_node_embedding"] = _legacy_encoder(sd, "atom_node_embedding", len(REC_ATOM_FEATURE_DIMS), old_enc)
    for name in ("lig_edge_embedding", "rec_edge_embedding", "atom_edge_embedding",
                 "lr_edge_embedding", "ar_edge_embedding", "la_edge_embedding"):
        params[name] = torch_fcblock(sd, name)

    def add_tpconv(our_name, ref_prefix, in_irreps, irreps_out, kind="trunk"):
        # legacy layers ALWAYS use the generic e3nn TP (old_score_model.py:94)
        p, s = torch_tpconv(sd, ref_prefix, irreps_out, 1, depth=2, batch_norm=c.batch_norm,
                            weight_perm=tp_perm_for_layer(c, in_irreps, irreps_out, kind,
                                                          force_generic=True))
        params[our_name] = p
        if s:
            stats[our_name] = s

    n = c.num_conv_layers
    for i in range(n):
        in_ir, out_ir = seq[min(i, 3)], seq[min(i + 1, 3)]
        n_groups = 3 if i == n - 1 else 9
        for g in range(n_groups):
            add_tpconv(f"{LEGACY_AA_GROUPS[g]}_{i}", f"conv_layers.{9 * i + g}", in_ir, out_ir)

    _legacy_heads(sd, c, params, stats, add_tpconv, seq[min(n, 3)])
    return {"params": params, "batch_stats": stats}


def normalize_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    """Reference checkpoint container -> flat {key: np.ndarray}.

    Handles the reference's three on-disk layouts (train.py:145-150,
    finetune_train.py:318-323): a raw ``model.state_dict()``, a bundle
    ``{epoch, model, optimizer, ema_weights}``, and DataParallel's
    ``module.``-prefixed keys. Torch tensors are detached to numpy."""
    if isinstance(obj, dict) and "model" in obj and not any(hasattr(v, "shape") for v in obj.values()):
        obj = obj["model"]
    out: Dict[str, np.ndarray] = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):  # torch tensor
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def convert_state_dict(torch_state_dict: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Reference checkpoint -> flax variables {params, batch_stats}.

    Dispatches on the architecture: all-atom configs (the pretrained
    confidence model) -> convert_all_atom_model; coarse-grained (the
    pretrained score model) -> convert_score_model. Accepts raw state
    dicts, ``{..., 'model': sd}`` bundles, and ``module.``-prefixed
    DataParallel dicts. Raises KeyError naming the first missing reference
    key when the checkpoint does not match the config's architecture.
    """
    sd = normalize_state_dict(torch_state_dict)
    if getattr(cfg, "old_score_model", False):
        if getattr(cfg, "all_atoms", False):
            return convert_legacy_all_atom_model(sd, cfg)
        return convert_legacy_score_model(sd, cfg)
    if getattr(cfg, "all_atoms", False):
        return convert_all_atom_model(sd, cfg)
    return convert_score_model(sd, cfg)
