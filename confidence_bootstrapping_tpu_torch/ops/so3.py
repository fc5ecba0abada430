"""IGSO(3) tables, sampling and score lookups.

Port of ``confidence_bootstrapping_tpu/ops/so3.py``. The JAX package builds
its cdf/score tables on the host at import. Here each table is built lazily,
with the same series in float64 on the device that asks for it, and cached
under ``.cache/`` (or ``$CBT_CACHE_DIR``): the score-norm vector (inference
reads it) and the full 2000 x 2000 cdf and score grids (training reads them).

Grid conventions match: 2000 log-spaced eps in [5e-4, 4], 2000 omegas in
(0, pi], enough series terms for convergence over the whole eps grid.
Sampling takes an explicit ``torch.Generator``; the inverse-cdf step is a
function of the uniforms (``inverse_cdf``), so a test can hand the port and
the JAX package the same draws.
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
_TABLES_FILE = "torch_so3_tables_v1.npz"


def cache_dir() -> str:
    d = os.environ.get("CBT_CACHE_DIR") or os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".cache")
    os.makedirs(d, exist_ok=True)
    return d


def eps_grid() -> np.ndarray:
    return 10 ** np.linspace(_LOG_MIN, _LOG_MAX, N_EPS)


def omega_grid(device="cpu") -> torch.Tensor:
    return torch.linspace(0, math.pi, X_N + 1, dtype=torch.float64, device=device)[1:]


def build_tables(eps=None, device="cpu"):
    """(cdf, score, score_norm) of the IGSO(3) angle marginal, float64, for
    each eps (default: the full grid): cdf and score [n_eps, X_N] on the omega
    grid, score_norm [n_eps] the RMS of the score. Rows are independent, so a
    test can build a few of them and compare with the JAX tables."""
    eps = torch.as_tensor(eps_grid() if eps is None else eps, dtype=torch.float64, device=device)
    omega = omega_grid(device)
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
    cdf = torch.cumsum(pdf, dim=1) / X_N * math.pi
    cdf = cdf / cdf[:, -1:]
    norm = torch.sqrt(torch.sum(score**2 * pdf, dim=1) / torch.sum(pdf, dim=1) / math.pi)
    return cdf, score, norm


def build_score_norm(eps=None, device="cpu") -> torch.Tensor:
    """RMS of the IGSO(3) score under the angle marginal, float64, for each
    eps (default: the full grid)."""
    return build_tables(eps, device)[2]


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


@functools.lru_cache(maxsize=None)
def _grids(device: torch.device):
    """(cdf, score) [N_EPS, X_N] float32 on ``device``, built at first use."""
    path = os.path.join(cache_dir(), _TABLES_FILE)
    if os.path.exists(path):
        z = np.load(path)
        cdf, score = torch.from_numpy(z["cdf"]), torch.from_numpy(z["score"])
    else:
        cdf, score, _ = build_tables(device=device)
        cdf, score = cdf.float().cpu(), score.float().cpu()
        np.savez(path, cdf=cdf.numpy(), score=score.numpy())
    return cdf.to(device), score.to(device)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` row by row: x [n], xp and fp [n, X] (each row sorted);
    constant beyond the ends, a zero-width step takes its left value."""
    X = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x[:, None].contiguous(), right=True), 1, X - 1)
    x0, x1 = torch.gather(xp, 1, i - 1)[:, 0], torch.gather(xp, 1, i)[:, 0]
    f0, f1 = torch.gather(fp, 1, i - 1)[:, 0], torch.gather(fp, 1, i)[:, 0]
    dx = x1 - x0
    flat = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, torch.ones_like(dx), dx) * (f1 - f0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def inverse_cdf(u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Rotation angles omega ~ IGSO(3)(eps) from uniforms u (same shape as
    eps): the JAX package's ``jnp.interp(u, cdf[eps], omegas)``."""
    cdf, _ = _grids(eps.device)
    omega = omega_grid(eps.device).to(torch.float32)
    rows = cdf[eps_index(eps).reshape(-1)]
    return interp(u.reshape(-1), rows, omega.expand_as(rows)).reshape(eps.shape)


def sample(eps: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Rotation angles omega ~ IGSO(3)(eps), same shape as eps."""
    u = torch.rand(eps.shape, generator=generator, device=eps.device)
    return inverse_cdf(u, eps)


def vec_from_draws(normals: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Rotation vectors: the directions of normals [..., 3] scaled by omega."""
    return normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-12) * omega[..., None]


def sample_vec(eps: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Rotation vectors eps.shape + (3,): uniform axis, IGSO(3) angle."""
    x = torch.randn(eps.shape + (3,), generator=generator, device=eps.device)
    return vec_from_draws(x, sample(eps, generator))


def score_vec(eps: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Score of the IGSO(3) density at rotation vector ``vec`` [..., 3]:
    linear interpolation over omega, nearest eps row."""
    _, score = _grids(eps.device)
    omega = omega_grid(eps.device).to(torch.float32)
    om = torch.linalg.norm(vec, dim=-1)
    rows = score[eps_index(eps).reshape(-1)]
    mag = interp(om.reshape(-1), omega.expand_as(rows), rows).reshape(om.shape)
    return mag[..., None] * vec / (om[..., None] + 1e-12)
