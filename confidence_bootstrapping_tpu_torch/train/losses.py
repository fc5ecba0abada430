"""Score-matching loss.

Port of ``confidence_bootstrapping_tpu/train/losses.py:score_matching_loss``:
per-manifold mean squared errors with the reference's normalizations
(translation weighted by sigma^2, rotation divided by the IGSO(3) RMS score
norm, torsion by the wrapped-normal E[score^2], masked means over valid
torsion slots) and the zero predictor's losses for logging.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import so3, torus
from ..ops.schedules import SigmaParams, t_to_sigma
from .diffusion import ScoreTargets


class LossBreakdown(NamedTuple):
    loss: torch.Tensor
    tr_loss: torch.Tensor
    rot_loss: torch.Tensor
    tor_loss: torch.Tensor
    tr_base_loss: torch.Tensor
    rot_base_loss: torch.Tensor
    tor_base_loss: torch.Tensor


def score_matching_loss(tr_pred, rot_pred, tor_pred, targets: ScoreTargets, batch, sigma: SigmaParams,
                        tr_weight: float = 1.0, rot_weight: float = 1.0, tor_weight: float = 1.0,
                        no_torsion: bool = False, apply_mean: bool = True) -> LossBreakdown:
    tr_sigma, rot_sigma, _ = t_to_sigma(batch.t_tr, batch.t_rot, batch.t_tor, sigma)

    def _m(x):
        return torch.mean(x) if apply_mean else torch.mean(x, dim=1)

    tr_loss = _m((tr_pred - targets.tr_score) ** 2 * tr_sigma[:, None] ** 2)
    tr_base = _m(targets.tr_score**2 * tr_sigma[:, None] ** 2)
    rot_norm = so3.score_norm(rot_sigma)[:, None]
    rot_loss = _m(((rot_pred - targets.rot_score) / rot_norm) ** 2)
    rot_base = _m((targets.rot_score / rot_norm) ** 2)
    if no_torsion:
        tor_loss = tor_base = torch.zeros_like(tr_loss)
    else:
        tor_norm2 = torus.score_norm(targets.tor_sigma)[:, None]
        m = batch.tor_mask.to(tr_pred.dtype)
        per_edge = (tor_pred - targets.tor_score) ** 2 / tor_norm2 * m
        per_edge_base = targets.tor_score**2 / tor_norm2 * m
        if apply_mean:
            cnt = torch.clamp(torch.sum(m), min=1.0)
            tor_loss, tor_base = torch.sum(per_edge) / cnt, torch.sum(per_edge_base) / cnt
        else:
            cnt = torch.sum(m, dim=1) + 1e-4
            tor_loss, tor_base = torch.sum(per_edge, dim=1) / cnt, torch.sum(per_edge_base, dim=1) / cnt
    loss = tr_loss * tr_weight + rot_loss * rot_weight + tor_loss * tor_weight
    return LossBreakdown(loss, tr_loss, rot_loss, tor_loss, tr_base, rot_base, tor_base)
