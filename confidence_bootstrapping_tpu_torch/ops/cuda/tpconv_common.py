"""What the TP-conv kernels share: host tables, weight layout, the plain
edge-message composition and the launch plumbing.

The Pallas kernels feed a 128x128 MXU: a CG matrix G, expand/reduce matrices
E/R, a u-major weight permutation and component-major outputs
(``ops/pallas/tpconv.py:ladder_spec``, ``tpconv_v3.py``). The Hopper kernels
need none of that. They read three small tables built here from
``WeightedTensorProduct``'s path metadata and write the canonical irreps
layout directly:

* the X table: one row per CG contribution X[g][u][c] of an edge
  (input slice, harmonic block, CG tensor, component);
* w2 with its columns reordered v-major inside each output group
  (n = ofs_g + v * fan_g + u) and 1/sqrt(fan_g) folded in, padded to a
  multiple of the kernels' column tile TN;
* the epilogue items of each column tile: (col_lo, col_hi, x_base, x_step,
  out_col), one per (g, v) segment in the tile and output component c.

The edge harmonics are ``1x0e + 1x1o`` (lmax=1, the score model) or
``1x0e + 1x1o + 1x2e`` (lmax=2, the all-atom confidence model); the harmonic
width (4 or 9) is a compile-time parameter of the kernels. Input and output
irreps may hold any l <= 1 blocks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..irreps import Irreps, WeightedTensorProduct, _sh_norms, clebsch_gordan

SH_IRREPS = "1x0e + 1x1o"  # lmax=1
SH2_IRREPS = "1x0e + 1x1o + 1x2e"  # lmax=2
SH_BASE = {0: 0, 1: 1, 2: 4}  # offset of each harmonic block in the sh vector
TN = 64  # column tile of the kernels (csrc/tpconv_engine.cuh: TN)
XROW = 8
EROW = 5


class TPLayout(NamedTuple):
    din: int
    dout: int
    weight_numel: int
    wpad: int
    n_tiles: int
    n_x: int  # CG contributions per edge (S)
    perm: np.ndarray  # [W] kernel column n -> WeightedTensorProduct column
    scale: np.ndarray  # [W] 1/sqrt(fan) of each kernel column
    xtab: np.ndarray  # [S, XROW] int32
    cg: np.ndarray  # float32
    epi: np.ndarray  # [items, EROW] int32
    epi_start: np.ndarray  # [n_tiles + 1] int32


def sh_dim(irreps_sh: str) -> int:
    """Width of the kernels' harmonic vector: 4 (lmax=1) or 9 (lmax=2)."""
    dims = {str(Irreps(SH_IRREPS)): 4, str(Irreps(SH2_IRREPS)): 9}
    key = str(Irreps(irreps_sh))
    if key not in dims:
        raise ValueError(f"TP-conv kernels take {SH_IRREPS} or {SH2_IRREPS} harmonics, got {irreps_sh}")
    return dims[key]


@functools.lru_cache(maxsize=None)
def tp_layout(irreps_in: str, irreps_out: str, irreps_sh: str = SH_IRREPS) -> TPLayout:
    sh_dim(irreps_sh)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    for _, ir in tuple(tp.irreps_in) + tuple(tp.irreps_out):
        if ir.l > 1:
            raise ValueError(f"TP-conv kernels take l <= 1 irreps, got {irreps_in} -> {irreps_out}")
    in_sl, out_sl = tp.irreps_in.slices(), tp.irreps_out.slices()
    xrows, cg, perm, scale, segs = [], [], [], [], []
    x_off = w_off = 0
    for g in tp.groups:
        mul_out, ir_out = tp.irreps_out[g.out_index]
        do, fan = ir_out.dim, g.fan_in
        for ii, si in g.paths:
            mul_in, ir_in = tp.irreps_in[ii]
            ir_sh = tp.irreps_sh[si].ir
            C = clebsch_gordan(ir_in.l, ir_sh.l, ir_out.l) * np.sqrt(do)
            cg_off = len(cg)
            cg.extend(C.ravel().tolist())
            for u in range(mul_in):
                for c in range(do):
                    xrows.append((in_sl[ii].start + u * ir_in.dim, ir_in.dim, SH_BASE[ir_sh.l], ir_sh.dim, do, c, cg_off, 0))
        for v in range(mul_out):
            for u in range(fan):
                perm.append(w_off + u * mul_out + v)
                scale.append(1.0 / np.sqrt(fan))
            n0 = w_off + v * fan
            segs.append((n0, n0 + fan, x_off, do, out_sl[g.out_index].start + v * do))
        x_off += fan * do
        w_off += fan * mul_out
    n_tiles = -(-w_off // TN)
    epi, epi_start = [], [0]
    for t in range(n_tiles):
        t0, t1 = t * TN, (t + 1) * TN
        for n0, n1, xg, do, oc in segs:
            lo, hi = max(n0, t0), min(n1, t1)
            if lo >= hi:
                continue
            for c in range(do):
                epi.append((lo - t0, hi - t0, xg + (lo - n0) * do + c, do, oc + c))
        epi_start.append(len(epi))
    return TPLayout(
        din=tp.irreps_in.dim,
        dout=tp.irreps_out.dim,
        weight_numel=w_off,
        wpad=n_tiles * TN,
        n_tiles=n_tiles,
        n_x=x_off,
        perm=np.asarray(perm, np.int64),
        scale=np.asarray(scale, np.float32),
        xtab=np.asarray(xrows, np.int32).reshape(-1, XROW),
        cg=np.asarray(cg, np.float32),
        epi=np.asarray(epi, np.int32).reshape(-1, EROW),
        epi_start=np.asarray(epi_start, np.int32),
    )


@functools.lru_cache(maxsize=None)
def device_tables(irreps_in: str, irreps_out: str, device: torch.device, irreps_sh: str = SH_IRREPS):
    """(xtab, cg, epi, epi_start, perm, scale) of tp_layout on ``device``."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    return tuple(
        torch.as_tensor(a, device=device) for a in (lay.xtab, lay.cg, lay.epi, lay.epi_start, lay.perm, lay.scale)
    )


class PackedWeights(NamedTuple):
    """An edge MLP's weights in the kernels' layout."""

    w1: torch.Tensor  # [F, H], contiguous float32
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, Wpad]: columns permuted, scaled by 1/sqrt(fan), zero-padded
    b2: torch.Tensor  # [Wpad]


@torch.no_grad()
def pack_weights(w1, b1, w2, b2, irreps_in: str, irreps_out: str, irreps_sh: str = SH_IRREPS) -> PackedWeights:
    """Edge-MLP weights (Flax's [in, out] layout) in the kernels' layout.
    Constant at inference: ``TPConv.packed_weights`` makes them once per
    edge group; a wrapper called without them makes them per launch."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    perm, scale = device_tables(irreps_in, irreps_out, w2.device, irreps_sh)[4:]
    H = w2.shape[0]
    w2p = torch.zeros(H, lay.wpad, dtype=torch.float32, device=w2.device)
    w2p[:, : lay.weight_numel] = w2.index_select(1, perm) * scale
    b2p = torch.zeros(lay.wpad, dtype=torch.float32, device=b2.device)
    b2p[: lay.weight_numel] = b2.index_select(0, perm) * scale
    return PackedWeights(w1.float().contiguous(), b1.float().contiguous(), w2p, b2p)


def launch_weights(w1, b1, w2, b2, irreps_in: str, irreps_out: str, packed, device,
                   irreps_sh: str = SH_IRREPS) -> PackedWeights:
    """The kernel-layout weights a launch reads: ``packed`` checked against
    the edge MLP's shapes and ``device``, or made now when it is None."""
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, irreps_in, irreps_out, irreps_sh)
    H, wpad = w2.shape[0], tp_layout(irreps_in, irreps_out, irreps_sh).wpad
    if (tuple(packed.w1.shape) != tuple(w1.shape) or tuple(packed.b1.shape) != (H,)
            or tuple(packed.w2.shape) != (H, wpad) or tuple(packed.b2.shape) != (wpad,)):
        raise ValueError("packed weights do not match the edge MLP's shapes")
    check_inputs(device, floats=tuple(packed))
    return packed


# --------------------------------------------------------------------------
# plain PyTorch pieces (the XLA composition of the JAX package)
# --------------------------------------------------------------------------


def sh1(vec: torch.Tensor) -> torch.Tensor:
    """lmax=1 harmonics as the kernels compute them: (1, sqrt(3) v / |v|) with
    |v|^2 clamped at 1e-12, so a zero vector (a masked self-edge) gives zero."""
    d2 = torch.clamp(torch.sum(vec * vec, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([torch.ones_like(d2), vec * torch.rsqrt(d2) * np.sqrt(3.0)], dim=-1)


def sh_kernel(vec: torch.Tensor, irreps_sh: str) -> torch.Tensor:
    """The harmonics of ``irreps_sh`` as the kernels compute them: those of
    ``ops.irreps.spherical_harmonics`` (the l=2 block xy, yz, 2z^2-x^2-y^2,
    zx, x^2-y^2 with ``_sh_norms(2)``) of v / |v|, |v|^2 clamped at 1e-12,
    so a zero vector gives zero in every l >= 1 component."""
    if sh_dim(irreps_sh) == 4:
        return sh1(vec)
    d2 = torch.clamp(torch.sum(vec * vec, dim=-1, keepdim=True), min=1e-12)
    u = vec * torch.rsqrt(d2)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    n = _sh_norms(2)
    l2 = torch.stack([n[0] * x * y, n[1] * y * z, n[2] * (2 * z * z - x * x - y * y), n[3] * z * x,
                      n[4] * (x * x - y * y)], dim=-1)
    return torch.cat([torch.ones_like(d2), u * np.sqrt(3.0), l2], dim=-1)


def edge_messages(eattr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str,
                  irreps_sh: str = SH_IRREPS) -> torch.Tensor:
    """Per-edge messages [..., Dout]: edge MLP -> TP weights -> weighted TP;
    masked edges exactly zero. w1 [F, H] and w2 [H, W] as Flax stores them."""
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    h = torch.relu(eattr @ w1 + b1)
    msg = tp(sender, sh, h @ w2 + b2)
    return torch.where(mask[..., None], msg, torch.zeros_like(msg))


# --------------------------------------------------------------------------
# launch plumbing
# --------------------------------------------------------------------------


def check_inputs(device: torch.device, floats=(), longs=(), bools=()) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device), is
    contiguous and has the dtype the kernels read."""
    if device.type != "cuda":
        raise ValueError(f"TP-conv kernels run on CUDA tensors, got {device}")
    for group, dtype in ((floats, torch.float32), (longs, torch.int64), (bools, torch.bool)):
        for t in group:
            if t.device != device or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(
                    f"expected a contiguous {dtype} tensor on {device}, got {t.dtype} on {t.device}"
                    f" (contiguous={t.is_contiguous()}, shape={tuple(t.shape)})"
                )


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
