"""Score-matching and confidence losses.

Port of ``confidence_bootstrapping_tpu/train/losses.py``:

* ``score_matching_loss``: per-manifold mean squared errors with the
  reference's normalizations (translation weighted by sigma^2, rotation
  divided by the IGSO(3) RMS score norm, torsion by the wrapped-normal
  E[score^2], masked means over valid torsion slots) and the zero
  predictor's losses for logging;
* ``confidence_loss`` (binary cross-entropy on logits, the one-hot binned
  cross-entropy, or the RMSD mean squared error) and
  ``atom_confidence_loss`` (binary or binned, padded atoms masked out of the
  mean), the confidence model's;
* ``affinity_loss``: the binding-affinity mean squared error, over the poses
  a validity mask keeps (the combined head) or over every group (the legacy
  affinity model).

Inside ``parallel.mesh.data_parallel`` the score-matching, torsion and
side-chain losses are this rank's share of the global batch's: each mean
is the local sum over the global count (``dp_mean``, ``psum``), so the
shares sum to the one-process loss and their gradients sum to its
gradient. The side-chain normalizers are global values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import so3, torus
from ..parallel.mesh import dp_mean, psum
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
        return dp_mean(x) if apply_mean else torch.mean(x, dim=1)

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
            cnt = torch.clamp(psum(torch.sum(m)), min=1.0)
            tor_loss, tor_base = torch.sum(per_edge) / cnt, torch.sum(per_edge_base) / cnt
        else:
            cnt = torch.sum(m, dim=1) + 1e-4
            tor_loss, tor_base = torch.sum(per_edge, dim=1) / cnt, torch.sum(per_edge_base, dim=1) / cnt
    loss = tr_loss * tr_weight + rot_loss * rot_weight + tor_loss * tor_weight
    return LossBreakdown(loss, tr_loss, rot_loss, tor_loss, tr_base, rot_base, tor_base)


def sidechain_losses(sidechain_pred, rec_sidechain, rec_mask):
    """Side-chain chi (circular) and backbone-vector regression losses of the
    side-chain head, as masked means: (sidechain_loss, backbone_loss,
    sidechain_base, backbone_base). ``rec_sidechain`` [B, N, 10]: chi1-4 in
    turns ([0, 1), NaN where undefined), then the CA->N and CA->C unit
    vectors."""
    m = rec_mask.to(sidechain_pred.dtype)
    chi, chi_pred = rec_sidechain[..., :4], sidechain_pred[..., :4]
    defined = torch.isfinite(chi) & rec_mask[..., None]
    zero = torch.zeros((), dtype=chi.dtype, device=chi.device)
    chi_s, chi_p = torch.where(defined, chi, zero), torch.where(defined, chi_pred, zero)
    diff = torch.abs(chi_p - chi_s)
    diff = torch.minimum(diff, 1.0 - diff)  # angles are circular: a full turn is 1
    n_def = torch.clamp(psum(defined.sum().to(chi.dtype)), min=1.0)
    chi_base = psum(torch.sum(chi_s**2 * defined)) / n_def + 1e-4
    sidechain_loss = torch.sum(diff**2 * defined) / n_def / chi_base
    bb, bb_pred = rec_sidechain[..., 4:], sidechain_pred[..., 4:]
    n_bb = torch.clamp(psum(m.sum()) * 6, min=1.0)
    bb_base = psum(torch.sum(bb**2 * m[..., None])) / n_bb + 1e-4
    backbone_loss = torch.sum((bb_pred - bb) ** 2 * m[..., None]) / n_bb / bb_base
    return sidechain_loss, backbone_loss, chi_base, bb_base


def _bce_with_logits(logits, labels):
    """Binary cross-entropy on logits, elementwise: labels * -log sigmoid(x)
    + (1 - labels) * -log(1 - sigmoid(x)), each term as log(1 + exp(.))."""
    return labels * torch.nn.functional.softplus(-logits) + (1 - labels) * torch.nn.functional.softplus(logits)


def confidence_loss(confidence_pred, labels, rmsd_prediction: bool = False):
    """Pose-level confidence loss: the mean squared error on the RMSD with
    ``rmsd_prediction``; the cross-entropy when the labels are one-hot over
    RMSD bins ([b, nbins], the list-cutoff mode); binary cross-entropy on
    logits otherwise."""
    if rmsd_prediction:
        return torch.mean((confidence_pred - labels) ** 2)
    if labels.ndim == confidence_pred.ndim and labels.ndim >= 2 and labels.shape[-1] > 1:
        return -torch.mean(torch.sum(labels * torch.log_softmax(confidence_pred, dim=-1), dim=-1))
    return torch.mean(_bce_with_logits(confidence_pred, labels))


def atom_confidence_loss(atom_pred, atom_labels, lig_mask):
    """Per-atom confidence loss over the real ligand atoms: binary
    cross-entropy for atom_pred [b, L] (or [b, L, 1]) with binary labels,
    cross-entropy for atom_pred [b, L, nbins] with one-hot bins; padded atoms
    are masked out of the mean."""
    m = lig_mask.to(atom_pred.dtype)
    if atom_pred.ndim == 3 and atom_pred.shape[-1] > 1:
        per_atom = -torch.sum(atom_labels * torch.log_softmax(atom_pred, dim=-1), dim=-1)
    else:
        atom_pred = atom_pred[..., 0] if atom_pred.ndim == 3 else atom_pred
        per_atom = _bce_with_logits(atom_pred, atom_labels)
    return torch.sum(per_atom * m) / torch.clamp(torch.sum(m), min=1.0)


def affinity_loss(affinity_pred, affinity_labels, valid=None):
    """Binding-affinity mean squared error. With ``valid`` (the combined
    head: poses whose RMSD is below the classification cutoff) the mean over
    the poses it keeps, zero when none is; otherwise (the legacy model's one
    affinity per pose group) over every element."""
    se = (affinity_pred - affinity_labels) ** 2
    if valid is None:
        return torch.mean(se)
    v = valid.to(torch.float32)
    return torch.sum(se * v) / torch.clamp(torch.sum(v), min=1.0)
