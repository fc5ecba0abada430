"""Training-time forward diffusion: noise draws, noised poses, score targets.

Port of ``confidence_bootstrapping_tpu/train/diffusion.py``: t ~ Beta(alpha,
beta) (with the CB ``minimum_t`` / ``sampling_mixing_coeff`` variants),
translation ~ N(0, sigma_tr), rotation ~ IGSO(3)(sigma_rot), torsions ~
N(0, sigma_tor) on valid torsion slots, the pose moved by
``modify_conformer``, and the closed-form score targets from the so3/torus
tables. ``apply_noise`` is split into ``draw_noise`` (every random number,
from one ``torch.Generator``) and ``apply_draws`` (the rest, deterministic),
so a test can hand the port the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import TrainConfig
from ..data.complex_graph import ComplexBatch
from ..ops import so3, torus
from ..ops.poses import modify_conformer
from ..ops.schedules import SigmaParams, t_to_sigma


class ScoreTargets(NamedTuple):
    tr_score: torch.Tensor  # [B, 3]
    rot_score: torch.Tensor  # [B, 3]
    tor_score: torch.Tensor  # [B, R]
    tor_sigma: torch.Tensor  # [B]


class NoiseDraws(NamedTuple):
    t: torch.Tensor  # [B] diffusion time (the same for the three manifolds)
    tr_update: torch.Tensor  # [B, 3], already scaled by sigma_tr
    rot_update: torch.Tensor  # [B, 3] rotation vectors
    tor_updates: torch.Tensor  # [B, R], scaled by sigma_tor, zero on padded slots


def sample_gamma(alpha: float, shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia and Tsang's method (alpha < 1 through
    Gamma(alpha + 1) * U^(1 / alpha)), float32."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.clamp(v, min=1e-30)))
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    if alpha < 1.0:
        out = out * torch.rand(shape, generator=generator, device=device) ** (1.0 / alpha)
    return out


def sample_beta(alpha: float, beta: float, shape, generator: torch.Generator, device) -> torch.Tensor:
    g1 = sample_gamma(alpha, shape, generator, device)
    return g1 / (g1 + sample_gamma(beta, shape, generator, device))


def sample_train_times(B: int, cfg: TrainConfig, generator: torch.Generator, device) -> torch.Tensor:
    """t ~ Beta(alpha, beta), floored at minimum_t or, with probability
    sampling_mixing_coeff, drawn below it."""
    t1 = sample_beta(cfg.sampling_alpha, cfg.sampling_beta, (B,), generator, device)
    t_high = cfg.minimum_t + t1 * (1 - cfg.minimum_t)
    if cfg.sampling_mixing_coeff == 0.0:
        return t_high
    t_low = sample_beta(cfg.sampling_alpha, cfg.sampling_beta, (B,), generator, device) * cfg.minimum_t
    choice = torch.rand((B,), generator=generator, device=device) < cfg.sampling_mixing_coeff
    return torch.where(choice, t_low, t_high)


def draw_noise(batch: ComplexBatch, sigma: SigmaParams, cfg: TrainConfig, generator: torch.Generator) -> NoiseDraws:
    B, dev = batch.batch_size, batch.lig_pos.device
    R = batch.tor_src.shape[1]
    t = sample_train_times(B, cfg, generator, dev)
    tr_sigma, rot_sigma, tor_sigma = t_to_sigma(t, t, t, sigma)
    tr_update = torch.randn((B, 3), generator=generator, device=dev) * tr_sigma[:, None]
    rot_update = so3.sample_vec(rot_sigma, generator)
    tor_updates = torch.randn((B, R), generator=generator, device=dev) * tor_sigma[:, None]
    return NoiseDraws(t, tr_update, rot_update, torch.where(batch.tor_mask, tor_updates, torch.zeros_like(tor_updates)))


def apply_draws(batch: ComplexBatch, draws: NoiseDraws, sigma: SigmaParams, no_torsion: bool = False):
    """(noised batch, targets) of a clean batch under the given draws."""
    t = draws.t
    batch = batch.set_time(t, t, t)
    tr_sigma, rot_sigma, tor_sigma = t_to_sigma(t, t, t, sigma)
    new_pos = modify_conformer(batch.lig_pos, batch.lig_mask, draws.tr_update, draws.rot_update,
                               None if no_torsion else draws.tor_updates, batch.tor_src, batch.tor_dst,
                               batch.mask_rotate, batch.tor_mask)
    tr_score = -draws.tr_update / (tr_sigma[:, None] ** 2)
    rot_score = so3.score_vec(rot_sigma, draws.rot_update)
    single = (torch.sum(batch.lig_mask, dim=1) <= 1)[:, None]  # one atom: no rotational signal
    rot_score = torch.where(single, torch.zeros_like(rot_score), rot_score)
    tor_score = torus.score(draws.tor_updates, tor_sigma[:, None])
    tor_score = torch.where(batch.tor_mask, tor_score, torch.zeros_like(tor_score))
    return batch.replace(lig_pos=new_pos), ScoreTargets(tr_score, rot_score, tor_score, tor_sigma)


def apply_noise(batch: ComplexBatch, sigma: SigmaParams, cfg: TrainConfig, generator: torch.Generator,
                no_torsion: bool = False):
    """Forward-diffuse a clean batch: (noised batch, targets)."""
    return apply_draws(batch, draw_noise(batch, sigma, cfg, generator), sigma, no_torsion)
