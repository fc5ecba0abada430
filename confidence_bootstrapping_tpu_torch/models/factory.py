"""Model factory: a config to the port's score, all-atom or legacy model,
and the translation of a reference ``model_parameters.yml`` manifest.

Port of ``confidence_bootstrapping_tpu/models/factory.py``: ``old_score_model``
selects the legacy architectures (``models/legacy.py``; ``all_atoms`` the
all-atom one). ``get_model`` builds every model the JAX package's builds,
and refuses, with a ``ValueError`` naming each such field, a config that asks
for what neither the port nor (where noted) the JAX package implements:

* ``sh_lmax >= 3``: harmonics of l = 3 and above in the trunk, which the
  port's kernels do not take (a later slice of the port);
* an all-atom model with protein-embedding layers but ``embed_also_ligand =
  false``: the JAX package raises there too (the widths do not match).

The legacy knobs (``separate_noise_schedule``, ``use_old_atom_encoder``,
``no_aminoacid_identities``, ``smooth_edges``, ``parallel``), which only the
legacy models read, pass through the modern ones, as in the JAX package;
``affinity_prediction`` gives the residue-level model its affinity column
and the all-atom model nothing. ``fixed_center_conv`` is read by the legacy
models only, so the modern ones build whatever its value, as the JAX
package's do; ``depthwise_convolution`` is read by the residue-level models
only (the all-atom ones ignore it, as in the JAX package). Fields only
training or the host reads pass through whatever their value: ``dropout``
and ``confidence_dropout`` (training), ``parallel_aggregators`` (read only
with ``parallel > 1``) and ``c_alpha_max_neighbors`` (featurization).
"""

from __future__ import annotations

from typing import Any, Dict

from ..config import ScoreModelConfig
from ..ops.schedules import SigmaParams
from ..runtime import resolve_device
from .all_atom_model import AllAtomScoreModel
from .legacy import OldAllAtomScoreModel, OldTensorProductScoreModel
from .score_model import TensorProductScoreModel

# (field, true where the config asks for what the port does not implement, what that is)
_UNSUPPORTED = (
    ("sh_lmax", lambda c: c.sh_lmax >= 3, "harmonics of l >= 3 in the trunk, a later slice of the port"),
    ("embed_also_ligand",
     lambda c: not c.old_score_model and c.all_atoms and not c.embed_also_ligand and c.num_prot_emb_layers > 0,
     "protein-embedding layers without the ligand's, which the JAX package refuses too"),
)


def unsupported_fields(cfg: ScoreModelConfig) -> list:
    """The fields of ``cfg`` whose values the port's models do not implement,
    each as "field=value (what it asks for)"."""
    return [f"{name}={getattr(cfg, name)!r} ({what})" for name, test, what in _UNSUPPORTED if test(cfg)]


def get_model(cfg: ScoreModelConfig, device=None, seed: int = 0):
    """The model ``cfg`` describes (``OldAllAtomScoreModel``,
    ``OldTensorProductScoreModel``, ``AllAtomScoreModel`` or
    ``TensorProductScoreModel``), with weights drawn from ``seed``, on
    ``device`` (default: the GPU; ``runtime.resolve_device``). Raises
    ``ValueError`` for a config the port does not implement."""
    bad = unsupported_fields(cfg)
    if bad:
        raise ValueError("the port does not implement this model config: " + "; ".join(bad))
    device = resolve_device(device)
    if cfg.old_score_model:
        return (OldAllAtomScoreModel if cfg.all_atoms else OldTensorProductScoreModel)(cfg, device=device, seed=seed)
    if cfg.all_atoms:
        return AllAtomScoreModel(cfg, device=device, seed=seed)
    return TensorProductScoreModel(cfg, device=device, seed=seed)


# reference flag -> our field; the inverted "no_*"/"not_*" flags below; flags
# absent from a manifest keep our defaults (the reference's back-compat behavior)
_DIRECT = {
    "ns": "ns",
    "nv": "nv",
    "sh_lmax": "sh_lmax",
    "num_conv_layers": "num_conv_layers",
    "num_prot_emb_layers": "num_prot_emb_layers",
    "embed_also_ligand": "embed_also_ligand",
    "use_second_order_repr": "use_second_order_repr",
    "reduce_pseudoscalars": "reduce_pseudoscalars",
    "dropout": "dropout",
    "sigma_embed_dim": "sigma_embed_dim",
    "distance_embed_dim": "distance_embed_dim",
    "cross_distance_embed_dim": "cross_distance_embed_dim",
    "max_radius": "lig_max_radius",
    "receptor_radius": "rec_max_radius",
    "cross_max_distance": "cross_max_distance",
    "dynamic_max_cross": "dynamic_max_cross",
    "embedding_type": "embedding_type",
    "embedding_scale": "embedding_scale",
    "scale_by_sigma": "scale_by_sigma",
    "no_torsion": "no_torsion",
    "smooth_edges": "smooth_edges",
    "odd_parity": "odd_parity",
    "tp_weights_layers": "tp_weights_layers",
    "depthwise_convolution": "depthwise_convolution",
    "all_atoms": "all_atoms",
    "atom_radius": "atom_radius",
    "atom_max_neighbors": "atom_max_neighbors",
    "c_alpha_max_neighbors": "c_alpha_max_neighbors",
    "crop_beyond": "crop_beyond",
    "confidence_dropout": "confidence_dropout",
    "confidence_no_batchnorm": "confidence_no_batchnorm",
    "affinity_prediction": "affinity_prediction",
    "separate_noise_schedule": "separate_noise_schedule",
    "use_old_atom_encoder": "use_old_atom_encoder",
    "no_aminoacid_identities": "no_aminoacid_identities",
    "parallel": "parallel",
    "parallel_aggregators": "parallel_aggregators",
}

_INVERTED = {
    "no_batch_norm": "batch_norm",
    "no_differentiate_convolutions": "differentiate_convolutions",
    "not_fixed_center_conv": "fixed_center_conv",
}

_SIGMAS = ("tr_sigma_min", "tr_sigma_max", "rot_sigma_min", "rot_sigma_max", "tor_sigma_min", "tor_sigma_max")
# the reference keys ESM features off an embeddings path or model flag, not a width; 1280: esm2_t33_650M
_ESM_KEYS = ("esm_embeddings_path", "moad_esm_embeddings_path", "pdbbind_esm_embeddings_path",
             "pdbsidechain_esm_embeddings_path", "esm_embeddings_model")


def config_from_reference_manifest(manifest: Dict[str, Any]) -> ScoreModelConfig:
    """A reference ``model_parameters.yml`` (an argparse dump) as our config,
    as the JAX package translates it: unknown flags are ignored, missing
    flags keep our defaults."""
    kwargs: Dict[str, Any] = {}
    for src, dst in _DIRECT.items():
        if manifest.get(src) is not None:
            kwargs[dst] = manifest[src]
    for src, dst in _INVERTED.items():
        if manifest.get(src) is not None:
            kwargs[dst] = not manifest[src]
    sig = {p: float(manifest[p]) for p in _SIGMAS if manifest.get(p) is not None}
    if sig:
        kwargs["sigma"] = SigmaParams(**sig)
    kwargs["lm_embedding_dim"] = 1280 if any(manifest.get(k) for k in _ESM_KEYS) else 0
    # confidence ("filtering") manifests carry classification flags
    if manifest.get("rmsd_classification_cutoff") is not None or manifest.get("confidence_mode"):
        kwargs["confidence_mode"] = True
        cut = manifest.get("rmsd_classification_cutoff")
        if isinstance(cut, (list, tuple)):
            kwargs["num_confidence_outputs"] = len(cut) + 1
        if manifest.get("atom_confidence_loss_weight"):
            kwargs["atom_confidence"] = True
    return ScoreModelConfig(**kwargs)
