"""Wrapped-normal score norm, the one torus table that inference reads.

Port of ``score_norm`` from ``confidence_bootstrapping_tpu/ops/torus.py``:
E[score^2] under the wrapped normal, by quadrature on a uniform grid over
(0, pi], series truncated at |i| <= 100 windings, on the JAX package's sigma
grid (5001 log-spaced sigma in [3e-3, 2] * pi). Built lazily in float64 on the
device that asks for it and cached under ``.cache/``; the full p/score tables
that training needs are not ported yet.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from .so3 import cache_dir

SIGMA_MIN, SIGMA_MAX, SIGMA_N = 3e-3, 2.0, 5000  # relative to pi
_N_WIND = 100
_LOG_S_MIN = math.log(SIGMA_MIN)
_LOG_S_MAX = math.log(SIGMA_MAX)
_CACHE_FILE = "torch_torus_score_norm_v1.npy"


def sigma_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(SIGMA_MIN), np.log10(SIGMA_MAX), SIGMA_N + 1) * np.pi


def build_score_norm(sigma=None, device="cpu") -> torch.Tensor:
    """E[score(x, sigma)^2] for each sigma (default: the full grid), float64."""
    sigma = torch.as_tensor(sigma_grid() if sigma is None else sigma, dtype=torch.float64, device=device)
    s2 = sigma[:, None] ** 2
    xs = torch.linspace(1e-7, math.pi, 4096, dtype=torch.float64, device=device)
    p = torch.zeros(sigma.shape[0], xs.shape[0], dtype=torch.float64, device=device)
    g = torch.zeros_like(p)
    for i in range(-_N_WIND, _N_WIND + 1):
        xi = xs[None, :] + 2 * math.pi * i
        e = torch.exp(-(xi**2) / (2 * s2))
        p += e
        g += xi / s2 * e
    bad = p <= 0
    s = torch.where(bad, 0.0, g / torch.where(bad, 1.0, p))
    return torch.sum(s**2 * p, dim=1) / torch.sum(p, dim=1)


@functools.lru_cache(maxsize=None)
def _table(device: torch.device) -> torch.Tensor:
    path = os.path.join(cache_dir(), _CACHE_FILE)
    if os.path.exists(path):
        table = torch.from_numpy(np.load(path))
    else:
        table = build_score_norm(device=device).cpu()
        np.save(path, table.numpy())
    return table.to(device=device, dtype=torch.float32)


def sigma_index(sigma: torch.Tensor) -> torch.Tensor:
    idx = (torch.log(sigma / math.pi) - _LOG_S_MIN) / (_LOG_S_MAX - _LOG_S_MIN) * SIGMA_N
    return torch.clamp(torch.round(idx), 0, SIGMA_N).long()


def score_norm(sigma: torch.Tensor) -> torch.Tensor:
    """E[score^2] under the wrapped normal at noise level sigma (gather)."""
    return _table(sigma.device)[sigma_index(sigma)]
