"""IGSO(3) score norm, the one SO(3) table that inference reads.

Port of ``score_norm`` from ``confidence_bootstrapping_tpu/ops/so3.py``. The
JAX package builds its full cdf/score tables on the host at import. Here only
the score-norm vector is built, lazily, with the same series in float64 on the
device that asks for it, and cached under ``.cache/`` (or ``$CBT_CACHE_DIR``).
The full tables that training needs are not ported yet.

Grid conventions match: 2000 log-spaced eps in [5e-4, 4], 2000 omegas in
(0, pi], enough series terms for convergence over the whole eps grid.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

MIN_EPS, MAX_EPS, N_EPS = 0.0005, 4.0, 2000
X_N = 2000
_LOG_MIN = math.log10(MIN_EPS)
_LOG_MAX = math.log10(MAX_EPS)
_CACHE_FILE = "torch_so3_score_norm_v1.npy"


def cache_dir() -> str:
    d = os.environ.get("CBT_CACHE_DIR") or os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".cache")
    os.makedirs(d, exist_ok=True)
    return d


def eps_grid() -> np.ndarray:
    return 10 ** np.linspace(_LOG_MIN, _LOG_MAX, N_EPS)


def build_score_norm(eps=None, device="cpu") -> torch.Tensor:
    """RMS of the IGSO(3) score under the angle marginal, float64, for each
    eps (default: the full grid). Rows are independent, so a test can build a
    few of them and compare with the JAX table."""
    eps = torch.as_tensor(eps_grid() if eps is None else eps, dtype=torch.float64, device=device)
    omega = torch.linspace(0, math.pi, X_N + 1, dtype=torch.float64, device=device)[1:]
    n_terms = int(math.ceil(math.sqrt(72) / MIN_EPS)) + 1  # tail term exp(-36)
    lo = torch.sin(omega / 2)
    dlo = 0.5 * torch.cos(omega / 2)
    expansion = torch.zeros(eps.shape[0], X_N, dtype=torch.float64, device=device)
    dexpansion = torch.zeros_like(expansion)
    chunk = 4000
    for l0 in range(0, n_terms, chunk):
        ls = torch.arange(l0, min(l0 + chunk, n_terms), dtype=torch.float64, device=device)
        A = (2 * ls + 1)[None, :] * torch.exp(-ls[None, :] * (ls[None, :] + 1) * (eps[:, None] ** 2) / 2)
        half = ls + 0.5
        hi = torch.sin(half[:, None] * omega[None, :])
        dhi = half[:, None] * torch.cos(half[:, None] * omega[None, :])
        expansion += A @ (hi / lo[None, :])
        dexpansion += A @ ((lo[None, :] * dhi - hi * dlo[None, :]) / (lo[None, :] ** 2))
    row_peak = torch.amax(torch.nan_to_num(expansion.abs(), nan=0.0), dim=1, keepdim=True)
    bad = ~torch.isfinite(expansion) | (expansion < row_peak * 1e-10)
    score = torch.where(bad, -omega[None, :] / (eps[:, None] ** 2), dexpansion / torch.where(bad, 1.0, expansion))
    pdf = torch.where(bad, 0.0, torch.clamp(expansion, min=0.0) * (1 - torch.cos(omega))[None, :] / math.pi)
    return torch.sqrt(torch.sum(score**2 * pdf, dim=1) / torch.sum(pdf, dim=1) / math.pi)


@functools.lru_cache(maxsize=None)
def _table(device: torch.device) -> torch.Tensor:
    path = os.path.join(cache_dir(), _CACHE_FILE)
    if os.path.exists(path):
        table = torch.from_numpy(np.load(path))
    else:
        table = build_score_norm(device=device).cpu()
        np.save(path, table.numpy())
    return table.to(device=device, dtype=torch.float32)


def eps_index(eps: torch.Tensor) -> torch.Tensor:
    """Nearest index of eps on the log grid (the JAX package's rounding)."""
    idx = (torch.log10(eps) - _LOG_MIN) / (_LOG_MAX - _LOG_MIN) * N_EPS
    return torch.clamp(torch.round(idx).long(), 0, N_EPS - 1)


def score_norm(eps: torch.Tensor) -> torch.Tensor:
    """RMS norm of the IGSO(3) score at noise level eps (table gather)."""
    return _table(eps.device)[eps_index(eps)]
