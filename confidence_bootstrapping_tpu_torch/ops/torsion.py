"""Torsion-angle updates on padded ligand batches.

Port of ``apply_torsion_updates`` from
``confidence_bootstrapping_tpu/ops/torsion.py``: the ``lax.scan`` over padded
torsion slots becomes a Python loop in the same order (order matters when
rotated atom sets nest). For rotatable edge (u, v) the axis is
pos[u] - pos[v] and the atoms flagged in ``mask_rotate`` rotate about pos[v].
"""

from __future__ import annotations

import torch

from .geometry import axis_angle_to_matrix


def apply_torsion_updates(pos, tor_src, tor_dst, mask_rotate, updates, tor_mask):
    """pos [B, L, 3], tor_src/tor_dst [B, R], mask_rotate [B, R, L],
    updates [B, R] radians, tor_mask [B, R] -> new positions [B, L, 3]."""
    R = updates.shape[-1]
    p = pos
    for r in range(R):
        u, v = tor_src[:, r].long(), tor_dst[:, r].long()
        pu = torch.gather(p, 1, u[:, None, None].expand(-1, 1, 3))[:, 0]
        pv = torch.gather(p, 1, v[:, None, None].expand(-1, 1, 3))[:, 0]
        axis = pu - pv
        axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-12)
        rot = axis_angle_to_matrix(axis * updates[:, r, None])
        rotated = torch.einsum("bld,bed->ble", p - pv[:, None, :], rot) + pv[:, None, :]
        sel = (mask_rotate[:, r] & tor_mask[:, r, None])[..., None]
        p = torch.where(sel, rotated, p)
    return p
