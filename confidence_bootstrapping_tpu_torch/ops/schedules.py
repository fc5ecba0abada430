"""Diffusion noise schedules and the sinusoidal time embedding.

Port of ``confidence_bootstrapping_tpu/ops/schedules.py``: exponential sigma
interpolation, the inverse-Beta-CDF inference time grid (host numpy/scipy) and
the sinusoidal timestep embedding (torch).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.stats import beta as _beta


class SigmaParams(NamedTuple):
    """Per-manifold sigma ranges (exponential schedule)."""

    tr_sigma_min: float = 0.1
    tr_sigma_max: float = 19.0
    rot_sigma_min: float = 0.06
    rot_sigma_max: float = 3.1
    tor_sigma_min: float = 0.0314
    tor_sigma_max: float = 3.14


def t_to_sigma_individual(t, sigma_min, sigma_max):
    """sigma(t) = sigma_min^(1-t) * sigma_max^t (exponential interpolation)."""
    return sigma_min ** (1 - t) * sigma_max**t


def t_to_sigma(t_tr, t_rot, t_tor, params: SigmaParams):
    """Map per-manifold diffusion times (floats or tensors) to noise levels."""
    return (
        t_to_sigma_individual(t_tr, params.tr_sigma_min, params.tr_sigma_max),
        t_to_sigma_individual(t_rot, params.rot_sigma_min, params.rot_sigma_max),
        t_to_sigma_individual(t_tor, params.tor_sigma_min, params.tor_sigma_max),
    )


def get_t_schedule(inference_steps, sigma_schedule="expbeta", inf_sched_alpha=1.0, inf_sched_beta=1.0, t_max=1.0):
    """Inference time grid: inverse-Beta-CDF spacing (host numpy, float32)."""
    if sigma_schedule != "expbeta":
        raise ValueError(sigma_schedule)
    lin_max = _beta.cdf(t_max, a=inf_sched_alpha, b=inf_sched_beta)
    c = np.linspace(lin_max, 0, inference_steps + 1)[:-1]
    return _beta.ppf(c, a=inf_sched_alpha, b=inf_sched_beta).astype(np.float32)


def sinusoidal_embedding(timesteps: torch.Tensor, embedding_dim: int, max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding; timesteps [N] -> [N, embedding_dim]."""
    half_dim = embedding_dim // 2
    scale = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -scale)
    emb = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def get_timestep_embedding(embedding_type: str, embedding_dim: int, embedding_scale: float = 10000):
    """Returns t -> embedding. Only the sinusoidal embedding is ported."""
    if embedding_type != "sinusoidal":
        raise ValueError(f"embedding_type {embedding_type!r} is not ported")
    return lambda x: sinusoidal_embedding(embedding_scale * x, embedding_dim)
