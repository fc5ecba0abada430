"""Typed configuration of the score and confidence models and the sampler.

Port of ``confidence_bootstrapping_tpu/config.py`` (``ScoreModelConfig``
and ``CBConfig`` with all of the JAX package's fields; the sampler's and the
training step's fields that the port reads) and of
``models/factory.py:confidence_model_config``, with the yaml round trip
of a model directory's ``model_config.yml`` (``to_dict``, ``from_dict``,
``save_yaml``, ``load_yaml``, ``load_score_config``). The yaml goes through
the port's own reader and writer (``yaml_io``): the machine that runs the
port need not have PyYAML. Field names and defaults equal the JAX package's,
so a config can be carried over with ``ScoreModelConfig(**fields)``; which
fields the port's models implement, ``models.factory.get_model`` checks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from . import yaml_io
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
    use_second_order_repr: bool = False
    reduce_pseudoscalars: bool = True
    batch_norm: bool = True
    dropout: float = 0.1  # training only: the edge MLPs, embeddings and heads
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
    smooth_edges: bool = False
    odd_parity: bool = False
    differentiate_convolutions: bool = True
    tp_weights_layers: int = 2
    fixed_center_conv: bool = True
    depthwise_convolution: bool = False
    sidechain_pred: bool = False

    # the legacy architectures and their knobs (the JAX package's
    # models/legacy.py; the port refuses them, models.factory.get_model)
    old_score_model: bool = False
    separate_noise_schedule: bool = False
    use_old_atom_encoder: bool = False
    no_aminoacid_identities: bool = False
    parallel: int = 1
    parallel_aggregators: str = "mean max min std"

    # confidence-mode heads
    confidence_mode: bool = False
    num_confidence_outputs: int = 1
    affinity_prediction: bool = False
    atom_confidence: bool = False
    atom_num_confidence_outputs: int = 1
    confidence_dropout: float = 0.0  # training only
    confidence_no_batchnorm: bool = False

    # all-atom variant
    all_atoms: bool = False
    atom_radius: float = 5.0
    atom_max_neighbors: int = 8

    # receptor graph (featurization only)
    c_alpha_max_neighbors: int = 24
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
    """Reverse-diffusion sampling knobs: every field of the JAX package's, in
    its order and with its defaults."""

    inference_steps: int = 20
    # run only the first actual_steps entries of the inference_steps-long schedule
    actual_steps: int | None = None
    shared_receptor: bool = True
    sigma_schedule: str = "expbeta"
    inf_sched_alpha: float = 1.0
    inf_sched_beta: float = 1.0
    # per-manifold time schedules: rot and tor on grids of their own
    different_schedules: bool = False
    rot_sigma_schedule: str = "expbeta"
    rot_inf_sched_alpha: float = 1.0
    rot_inf_sched_beta: float = 1.0
    tor_sigma_schedule: str = "expbeta"
    tor_inf_sched_alpha: float = 1.0
    tor_inf_sched_beta: float = 1.0
    # upper limit of the tr time grid (infer sets it below 1 in pocket mode)
    t_max: float = 1.0
    no_random: bool = False
    no_final_step_noise: bool = False
    ode: bool = False
    temp_sampling: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    temp_psi: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    temp_sigma_data: float = 0.5
    # scale of the prior's translation noise; the CLIs pass it to
    # randomize_position, as in the JAX package
    initial_noise_std_proportion: float = 1.0
    rec_phase_steps: Tuple[int, ...] = ()
    rec_phase_caps: Tuple[int, ...] = ()
    rec_phase_margin: float = 5.0
    # derive the plan above per receptor when it is empty
    # (``sampler.sampling.derive_phase_plan``), as the JAX package's CLIs do
    rec_phase_auto: bool = True
    # SVGD particle coupling across the pose batch (``sampler.sampling.
    # _svgd_perturbations``); on when svgd_weight_log_0 and _1 are both set.
    # Each *_log_0/_1 pair interpolates log10 of a weight over the steps.
    svgd_weight_log_0: Optional[float] = None
    svgd_weight_log_1: Optional[float] = None
    svgd_repulsive_weight_log_0: Optional[float] = None
    svgd_repulsive_weight_log_1: Optional[float] = None
    svgd_kernel_size_log_0: Optional[float] = None
    svgd_kernel_size_log_1: Optional[float] = None
    svgd_langevin_weight_log_0: Optional[float] = None
    svgd_langevin_weight_log_1: Optional[float] = None
    svgd_rot_log_rel_weight: float = 0.0
    svgd_tor_log_rel_weight: float = 0.0
    svgd_use_x0: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training-step knobs (the fields ``train/train_loop`` and
    ``train/diffusion`` read, and the batch a caller makes, as
    ``chip_smoke.py``'s timed steps and the CB fine-tune do), defaults as the
    JAX package's."""

    lr: float = 1e-3
    w_decay: float = 0.0
    batch_size: int = 16
    ema_rate: float = 0.999
    tr_weight: float = 0.33
    rot_weight: float = 0.33
    tor_weight: float = 0.33
    # forward-diffusion time sampling t ~ Beta(alpha, beta)
    sampling_alpha: float = 2.0
    sampling_beta: float = 1.0
    grad_clip: Optional[float] = None
    # CB time floor / mixing
    minimum_t: float = 0.0
    sampling_mixing_coeff: float = 0.0


@dataclass(frozen=True)
class CBConfig:
    """Confidence-Bootstrapping loop knobs (``bootstrapping/finetune.py``):
    every field and default of the JAX package's ``CBConfig``, the
    reference's recipe (10 epochs, 8 samples, cutoff -4, fixed_length 100).
    The loop reads every field but ``cb_cluster``, ``inference_batch_size``
    and ``total_trainset_size``, which the JAX package's loop does not read
    either (its command line sets them)."""

    cb_cluster: str = ""
    n_epochs: int = 10
    cb_inference_freq: int = 5
    inference_samples: int = 8
    inference_steps: int = 20
    inference_batch_size: int = 8
    num_inference_complexes: Optional[int] = 100
    confidence_cutoff: float = -4.0
    oracle_confidence: bool = False  # -RMSD instead of the confidence model's score
    initial_iterations: int = 5
    inference_iterations: int = 4
    limit_failures: int = 5
    # buffer
    max_complexes_per_couple: Optional[int] = 5
    fixed_length: Optional[int] = 100
    temperature: float = 1.0
    buffer_decay: float = 0.0
    reset_buffer: bool = False
    # fine-tune time sampling
    minimum_t: float = 0.0
    sampling_mixing_coeff: float = 0.0
    sampling_alpha: float = 2.0
    sampling_beta: float = 1.0
    keep_original_train: bool = False
    total_trainset_size: int = 100
    batch_size: int = 16
    lr: float = 1e-3
    use_ema_for_rollouts: bool = True


def to_dict(cfg) -> dict:
    """A config dataclass as plain data: nested dicts, lists for tuples
    (``sigma`` as a dict), as the JAX package's ``to_dict`` gives it."""

    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if hasattr(v, "_asdict"):  # a NamedTuple (SigmaParams)
            return {k: clean(x) for k, x in v._asdict().items()}
        if isinstance(v, tuple):
            return list(v)
        return v

    return clean(dataclasses.asdict(cfg))


def from_dict(cls, d: dict):
    """The config dataclass ``cls`` from a dict, as the JAX package rebuilds
    it: unknown keys are ignored, ``sigma`` may be a dict or a list, and a
    tuple field may come as a list."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if k == "sigma" and isinstance(v, dict):
            v = SigmaParams(**v)
        elif k == "sigma" and isinstance(v, (list, tuple)):
            v = SigmaParams(*v)
        elif str(names[k].type).startswith("Tuple") and isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def save_yaml(cfg, path: str) -> None:
    """Write ``to_dict(cfg)`` as ``yaml.safe_dump(..., sort_keys=True)`` writes it."""
    with open(path, "w") as f:
        f.write(yaml_io.dump(to_dict(cfg)))


def load_yaml(cls, path: str):
    with open(path) as f:
        return from_dict(cls, yaml_io.load(f.read()))


def load_score_config(path: str) -> ScoreModelConfig:
    return load_yaml(ScoreModelConfig, path)
