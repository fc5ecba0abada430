"""Typed configuration of the score and confidence models and the sampler.

Port of ``confidence_bootstrapping_tpu/config.py`` for the fields the port
reads (score mode, the all-atom confidence model, sampling), and of
``models/factory.py:confidence_model_config``. No yaml: the machine that runs
the port need not have it. Field names and defaults equal the JAX package's,
so a config can be carried over with ``ScoreModelConfig(**fields)``; dropout
is not a field (the port runs inference only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from .ops.schedules import SigmaParams


@dataclass(frozen=True)
class ScoreModelConfig:
    """Architecture knobs of the tensor-product score and confidence models.

    Defaults reproduce the pretrained score model's manifest.
    """

    ns: int = 32
    nv: int = 6
    sh_lmax: int = 1
    num_conv_layers: int = 5
    num_prot_emb_layers: int = 3
    embed_also_ligand: bool = True
    reduce_pseudoscalars: bool = True
    batch_norm: bool = True
    in_lig_edge_features: int = 4
    sigma_embed_dim: int = 32
    distance_embed_dim: int = 32
    cross_distance_embed_dim: int = 32
    lig_max_radius: float = 5.0
    rec_max_radius: float = 15.0
    cross_max_distance: float = 80.0
    center_max_distance: float = 30.0
    dynamic_max_cross: bool = True
    cross_cap: int = 48
    cross_cap_frac: float = 0.2
    atom_cross_cap: int = 32  # ligand <- receptor-atom cross capacity per ligand atom
    lm_embedding_dim: int = 1280  # 0 disables ESM features
    embedding_type: str = "sinusoidal"
    embedding_scale: int = 1000
    scale_by_sigma: bool = True
    no_torsion: bool = False
    odd_parity: bool = False
    differentiate_convolutions: bool = True

    # confidence-mode heads
    confidence_mode: bool = False
    num_confidence_outputs: int = 1
    atom_confidence: bool = False
    atom_num_confidence_outputs: int = 1
    confidence_no_batchnorm: bool = False

    # all-atom variant
    all_atoms: bool = False
    atom_radius: float = 5.0
    atom_max_neighbors: int = 8
    # crop: residues farther than crop_beyond from every ligand atom are
    # dropped with their atoms; score_confidence packs what is kept into
    # (crop_res_cap, crop_atom_cap) buckets, the nearest first on overflow
    crop_beyond: Optional[float] = None
    crop_res_cap: int = 256
    crop_atom_cap: int = 2048

    sigma: SigmaParams = field(default_factory=SigmaParams)

    def effective_cross_cap(self, n_rec: int) -> int:
        """Cross-edge capacity for an N-residue receptor view, as the JAX
        package computes it: min(N, max(cross_cap, ceil32(int(N * frac))))."""
        if self.cross_cap_frac and self.cross_cap_frac > 0:
            scaled = -(-int(n_rec * self.cross_cap_frac) // 32) * 32
            return min(n_rec, max(self.cross_cap, scaled))
        return min(n_rec, self.cross_cap)


def confidence_model_config(ns: int = 24, nv: int = 6, sh_lmax: int = 2, **overrides) -> ScoreModelConfig:
    """The pretrained confidence architecture's manifest defaults: the
    all-atom model in confidence mode, lmax=2, 5 trunk layers and no
    protein-embedding layers, no pseudoscalar reduction, crop at 20 A."""
    kwargs = dict(
        ns=ns,
        nv=nv,
        sh_lmax=sh_lmax,
        num_conv_layers=5,
        num_prot_emb_layers=0,
        embed_also_ligand=False,
        reduce_pseudoscalars=False,
        all_atoms=True,
        confidence_mode=True,
        crop_beyond=20.0,
        dynamic_max_cross=True,
        embedding_scale=10000,
    )
    kwargs.update(overrides)
    return ScoreModelConfig(**kwargs)


@dataclass(frozen=True)
class SamplerConfig:
    """Reverse-diffusion sampling knobs (the subset this slice ports)."""

    inference_steps: int = 20
    actual_steps: int | None = None
    shared_receptor: bool = True
    sigma_schedule: str = "expbeta"
    inf_sched_alpha: float = 1.0
    inf_sched_beta: float = 1.0
    t_max: float = 1.0
    no_random: bool = False
    no_final_step_noise: bool = False
    ode: bool = False
    temp_sampling: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    temp_psi: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    temp_sigma_data: float = 0.5
    rec_phase_steps: Tuple[int, ...] = ()
    rec_phase_caps: Tuple[int, ...] = ()
    rec_phase_margin: float = 5.0
