"""Pose update: rigid + torsional conformer modification.

Port of ``confidence_bootstrapping_tpu/ops/poses.py``: translate and rotate
the ligand about its centroid, apply the torsion updates, then Kabsch-align
the flexible result back onto the rigid pose.
"""

from __future__ import annotations

import torch

from .geometry import axis_angle_to_matrix, kabsch_align
from .torsion import apply_torsion_updates


def modify_conformer(pos, lig_mask, tr_update, rot_update, tor_updates, tor_src, tor_dst, mask_rotate, tor_mask):
    """pos [B, L, 3], lig_mask [B, L], tr_update/rot_update [B, 3],
    tor_updates [B, R] or None -> new positions [B, L, 3]."""
    m = lig_mask.to(pos.dtype)[..., None]
    center = torch.sum(pos * m, dim=1, keepdim=True) / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1e-12)
    rot_mat = axis_angle_to_matrix(rot_update)
    rigid = torch.einsum("bld,bed->ble", pos - center, rot_mat) + tr_update[:, None, :] + center
    if tor_updates is None or tor_updates.shape[-1] == 0:
        return rigid
    flexible = apply_torsion_updates(rigid, tor_src, tor_dst, mask_rotate, tor_updates, tor_mask)
    aligned = kabsch_align(flexible, rigid, lig_mask)
    has_tor = torch.any(tor_mask, dim=-1)[:, None, None]
    return torch.where(has_tor, aligned, rigid)
