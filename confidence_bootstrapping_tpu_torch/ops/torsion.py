"""Torsion-angle updates on padded ligand batches.

Port of ``apply_torsion_updates`` from
``confidence_bootstrapping_tpu/ops/torsion.py``: the ``lax.scan`` over padded
torsion slots becomes a Python loop in the same order (order matters when
rotated atom sets nest). For rotatable edge (u, v) the axis is
pos[u] - pos[v] and the atoms flagged in ``mask_rotate`` rotate about pos[v].
``get_torsion_angles`` measures the dihedrals SVGD compares.
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


def _bdot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def get_torsion_angles(dihedral, pos):
    """Current torsion angles of dihedral tuples (c, a, b, d): dihedral
    [R, 4] int, pos [B, L, 3] -> angles [B, R] in (-pi, pi), by the JAX
    package's projection formula."""
    c, a, b, d = (dihedral[:, k].long() for k in range(4))
    pa, pb, pc, pd = pos[:, a], pos[:, b], pos[:, c], pos[:, d]
    ab = pb - pa
    c_proj = pa + _bdot(pc - pa, ab) / (_bdot(ab, ab) + 1e-12) * ab
    d_proj = pa + _bdot(pd - pa, ab) / (_bdot(ab, ab) + 1e-12) * ab
    v1 = pd - d_proj
    v2 = pc - c_proj
    cos = _bdot(v1, v2) / (torch.linalg.norm(v1, dim=-1, keepdim=True) * torch.linalg.norm(v2, dim=-1, keepdim=True)
                           + 1e-12)
    angle = torch.arccos(torch.clamp(cos, -1 + 1e-5, 1 - 1e-5))
    sign = torch.sign(_bdot(torch.linalg.cross(v1, v2, dim=-1), ab))
    return (angle * sign)[..., 0]
