"""Rotation representations and batched Kabsch alignment.

Port of the parts of ``confidence_bootstrapping_tpu/ops/geometry.py`` that
sampling reads: quaternion/axis-angle to matrix and the reflection-corrected
Kabsch fit. Shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (real first, [..., 4]) -> rotation matrix [..., 3, 3]."""
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> quaternion [..., 4] (real first)."""
    angles = torch.linalg.norm(v, dim=-1, keepdim=True)
    half = 0.5 * angles
    small = torch.abs(angles) < 1e-6
    # sin(x/2)/x ~= 1/2 - x^2/48 for small x
    sin_half_over = torch.where(small, 0.5 - angles * angles / 48, torch.sin(half) / torch.where(small, 1.0, angles))
    return torch.cat([torch.cos(half), v * sin_half_over], dim=-1)


def axis_angle_to_matrix(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> rotation matrix [..., 3, 3]."""
    return quaternion_to_matrix(axis_angle_to_quaternion(v))


def rigid_transform_kabsch(A: torch.Tensor, B: torch.Tensor, mask=None):
    """Rigid transform aligning point set A onto B: (R [..., 3, 3],
    t [..., 1, 3]) with A @ R^T + t ~= B, det(R) = +1.

    The 3x3 SVD runs in float64: cuSOLVER's and LAPACK's float32 SVDs pick
    different singular-vector signs and rounding, and float64 keeps the
    rotation the same to float32 precision on both devices."""
    w = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device) if mask is None else mask.to(A.dtype)
    wsum = torch.sum(w, dim=-1, keepdim=True)[..., None] + 1e-12
    cA = torch.sum(A * w[..., None], dim=-2, keepdim=True) / wsum
    cB = torch.sum(B * w[..., None], dim=-2, keepdim=True) / wsum
    Am = (A - cA) * w[..., None]
    Bm = (B - cB) * w[..., None]
    H = torch.einsum("...ni,...nj->...ij", Am.double(), Bm.double())
    U, _, Vt = torch.linalg.svd(H)
    R = torch.einsum("...ji,...kj->...ik", Vt, U)  # Vt^T @ U^T
    det = torch.linalg.det(R)
    d = torch.tensor([1.0, 1.0, -1.0], dtype=R.dtype, device=R.device)
    Rm = torch.einsum("...ji,j,...kj->...ik", Vt, d, U)
    R = torch.where(det[..., None, None] < 0, Rm, R).to(A.dtype)
    t = cB - torch.einsum("...ij,...kj->...ki", R, cA)
    return R, t


def kabsch_align(A: torch.Tensor, B: torch.Tensor, mask=None) -> torch.Tensor:
    """A rigidly aligned onto B: A @ R^T + t."""
    R, t = rigid_transform_kabsch(A, B, mask)
    return torch.einsum("...ni,...ji->...nj", A, R) + t
