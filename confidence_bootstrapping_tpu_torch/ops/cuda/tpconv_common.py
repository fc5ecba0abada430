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

The tensor-core stage of the rec (with and without the dropout mask), pb,
cross_rev, rec_g, row 4 and edge-list kernels (3xTF32 ``wgmma``) reads w2
split into TF32 parts, ``w2_hi = tf32(w2)`` and
``w2_lo = tf32(w2 - w2_hi)`` (round to nearest, ties away from zero, as
``cvt.rna.tf32.f32``), each cut into TNC-column tiles stored in the layout
``wgmma`` reads: per tile [TNC/8][Hp/4][8][4], core matrices of 8 columns x 4
k (16 bytes a row), H padded with zero rows to Hp, a multiple of 8
(``tile_w2``). Its epilogue tables are ``tp_layout``'s for TNC-column tiles.
Each kernel has more than one build (the tensor-core stage, the float32
stage at 64 or 32 edges a chunk); ``pick_build`` chooses the one a layer
fits from a host mirror of their shared-memory layouts
(``engine_smem_bytes``).

The edge harmonics are ``1x0e + 1x1o`` (lmax=1, the score model),
``1x0e + 1x1o + 1x2e`` (lmax=2, the all-atom confidence model) or, for the
edge-list kernel that takes them as input, the score model's torsion-head
harmonics ``1x2e + 1x1o + 1x2o + 1x3o``; the harmonic width (4, 9 or 20) is a
compile-time parameter of the kernels. Input and output irreps may hold any
l <= 2 blocks (l = 2: the second-order irreps ladder). ``general_route``
says whether a layer takes the general kernels (rec_g, cross_g and the
edge-list kernel) as the JAX package's ``tpconv_g.general_layout`` does.

The training backward (``csrc/tpconv_bwd.cu``) reads w2 in its canonical
column order and three more tables (``bwd_layout``); its tensor-core build
packs that order's TNC-column hi/lo tiles on the card per call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..irreps import FullTensorProduct, Irreps, WeightedTensorProduct, _sh_norms, clebsch_gordan

SH_IRREPS = "1x0e + 1x1o"  # lmax=1
SH2_IRREPS = "1x0e + 1x1o + 1x2e"  # lmax=2
TOR_SH_IRREPS = str(FullTensorProduct(SH_IRREPS, "1x2e").irreps_out)  # the torsion head's, 1x2e + 1x1o + 1x2o + 1x3o
TN = 64  # column tile of the kernels (csrc/tpconv_engine.cuh: TN, csrc/tpconv_bwd.cu: BN)
TNC = 48  # column tile of the tensor-core stage (csrc/tpconv_engine.cuh: TNC)
KMAX = 96  # the largest hidden width H the tensor-core stage takes (csrc/tpconv_engine.cuh: KMAX)
TM = 64  # edges per chunk: the tensor-core stage and the float32 stage's default build (csrc/tpconv_engine.cuh: TM)
TM_WIDE = 32  # edges per chunk of the float32 builds for layers whose TM-edge layout does not fit
SMEM_LIMIT = 232_448  # bytes of shared memory (static and dynamic) one block may take on an H100
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


def _sh_dims() -> dict:
    return {str(Irreps(SH_IRREPS)): 4, str(Irreps(SH2_IRREPS)): 9, str(Irreps(TOR_SH_IRREPS)): 20}


def takes_harmonics(irreps_sh: str) -> bool:
    """Whether the TP-conv kernels take these harmonics (``sh_dim``)."""
    return str(Irreps(irreps_sh)) in _sh_dims()


def sh_dim(irreps_sh: str) -> int:
    """Width of the kernels' harmonic vector: 4 (lmax=1), 9 (lmax=2) or 20
    (the torsion head's, edge-list kernel only)."""
    if not takes_harmonics(irreps_sh):
        raise ValueError(f"TP-conv kernels take {SH_IRREPS}, {SH2_IRREPS} or {TOR_SH_IRREPS} harmonics, got {irreps_sh}")
    return _sh_dims()[str(Irreps(irreps_sh))]


_LADDER_ORDER = ("0e", "1o", "1e", "0o")


def is_ladder(irreps_in: str, irreps_out: str) -> bool:
    """Whether both irreps are shaped as the lmax=1 ladder (blocks of 0e, 1o,
    1e and 0o, each at most once, in that order), as the JAX package's
    ``tpconv.ladder_spec`` tests it: with lmax=1 harmonics such a layer takes
    the ladder kernels (rows 1-6)."""
    for irreps in (irreps_in, irreps_out):
        seen = [str(ir) for mul, ir in Irreps(irreps) if mul > 0]
        if any(k not in _LADDER_ORDER for k in seen) or seen != [k for k in _LADDER_ORDER if k in seen]:
            return False
    return True


def block_width(irreps: str) -> int:
    """The tensor-core stage's build for these irreps' widest block: 3 (l <= 1)
    or 5 (l = 2, the second-order ladder). The input irreps select the CG
    loop of the forward stage (``contributions_tc``'s DI), the output irreps
    the backward's d_w loop (its NC): builds of their own, so that l <= 1
    layers keep their code."""
    return 5 if max(ir.dim for _, ir in Irreps(irreps)) > 3 else 3


FAN_MAX = 128  # the largest fan-in of an output group the JAX package's general kernels take (one lane group)


@functools.lru_cache(maxsize=None)
def general_route(irreps_in: str, irreps_sh: str, irreps_out: str) -> bool:
    """Whether a layer takes the general kernels: harmonics the kernels take
    (``takes_harmonics``), blocks of l <= 2 and every output group's fan-in
    at most FAN_MAX, where ``tpconv_g.general_layout`` of the JAX package
    raises and its layer runs plain XLA."""
    if not takes_harmonics(irreps_sh):
        return False
    try:
        tp_layout(irreps_in, irreps_out, irreps_sh)
    except ValueError:
        return False
    return all(g.fan_in <= FAN_MAX for g in WeightedTensorProduct(irreps_in, irreps_sh, irreps_out).groups)


@functools.lru_cache(maxsize=None)
def tp_layout(irreps_in: str, irreps_out: str, irreps_sh: str = SH_IRREPS, tn: int = TN) -> TPLayout:
    """The kernels' tables for ``tn``-column tiles of w2 (TN: the float32
    stage, TNC: the tensor-core stage)."""
    sh_dim(irreps_sh)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    for _, ir in tuple(tp.irreps_in) + tuple(tp.irreps_out):
        if ir.l > 2:
            raise ValueError(f"TP-conv kernels take l <= 2 irreps, got {irreps_in} -> {irreps_out}")
    in_sl, out_sl, sh_sl = tp.irreps_in.slices(), tp.irreps_out.slices(), tp.irreps_sh.slices()
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
                    xrows.append((in_sl[ii].start + u * ir_in.dim, ir_in.dim, sh_sl[si].start, ir_sh.dim, do, c, cg_off, 0))
        for v in range(mul_out):
            for u in range(fan):
                perm.append(w_off + u * mul_out + v)
                scale.append(1.0 / np.sqrt(fan))
            n0 = w_off + v * fan
            segs.append((n0, n0 + fan, x_off, do, out_sl[g.out_index].start + v * do))
        x_off += fan * do
        w_off += fan * mul_out
    n_tiles = -(-w_off // tn)
    epi, epi_start = [], [0]
    for t in range(n_tiles):
        t0, t1 = t * tn, (t + 1) * tn
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
        wpad=n_tiles * tn,
        n_tiles=n_tiles,
        n_x=x_off,
        perm=np.asarray(perm, np.int64),
        scale=np.asarray(scale, np.float32),
        xtab=np.asarray(xrows, np.int32).reshape(-1, XROW),
        cg=np.asarray(cg, np.float32),
        epi=np.asarray(epi, np.int32).reshape(-1, EROW),
        epi_start=np.asarray(epi_start, np.int32),
    )


class Dims(NamedTuple):
    """csrc/tpconv_engine.cuh: Dims. F is the MLP input width (Fe + 2 ns for
    the gather kernels, the edge-list kernel's whole F with ns = 0)."""

    Fe: int
    ns: int
    F: int
    H: int
    Din: int
    Dout: int


def _r4(x: int) -> int:
    return (x + 3) & ~3


def engine_smem_bytes(shd: int, tm: int, d: Dims, S: int, rt: int, tc: bool = False, n_cg: int = 0, n_epi: int = 0,
                      n_tiles: int = 0) -> int:
    """Dynamic shared memory of one engine block: the host mirror of
    ``make_layout`` (float32 stage, ``tm`` edges a chunk) and, with ``tc``,
    of ``make_layout_tc`` (tensor-core stage, TM edges a chunk) in
    csrc/tpconv_engine.cuh. Every kernel library exports the C++ value
    (``cbt_smem_bytes``); chip_smoke.py holds the two against each other."""
    ldz, ldx, ldsh, ldxs, ldm = d.F | 1, d.Din | 1, shd | 1, S | 1, d.Dout | 1
    if not tc:
        zx = _r4(tm * ldz) + _r4(tm * ldx)
        wc = _r4(d.H * TN) + _r4(tm * (TN + 1))
        o = max(zx, wc) + _r4(tm * ldsh) + _r4(d.H * tm) + _r4(tm * ldxs) + _r4(tm * ldm) + _r4(rt * d.Dout)
        return 4 * o
    hp = -(-d.H // 8) * 8
    ring, csz = 4 * TNC * hp, _r4(TM * (TNC + 1))
    h = _r4(TM * ldz) + _r4(TM * ldx) + _r4(TM * ldsh)
    o = max(ring + csz, h + _r4(TM * (hp + 4)))
    o += _r4(max(TM * ldxs, d.F * d.H))
    o += _r4(max(TM * ldm, S * XROW + n_cg))
    o += _r4(rt * d.Dout) + _r4(n_epi * EROW + n_tiles + 1)
    return 4 * o


def engine_static_bytes(tm: int, tc: bool) -> int:
    """Static shared memory of an engine kernel: its EdgeSlots (48 bytes an
    edge slot and two ints) and, on the tensor-core stage, the ring's two
    barriers, rounded up to 16 bytes. Every kernel library exports the
    value of its kernels (``cbt_static_smem_bytes``); chip_smoke.py holds
    the two against each other."""
    return (48 * tm + 8 + (16 if tc else 0) + 15) & ~15


@functools.lru_cache(maxsize=None)
def pick_build(what: str, irreps_in: str, irreps_out: str, irreps_sh: str, d: Dims, rt: int, tc: bool,
               tms=(TM, TM_WIDE)) -> tuple:
    """The build of an engine kernel that a layer takes: (tensor cores?,
    edges a chunk). With ``tc``, the tensor-core stage when H <= KMAX and its
    layout fits SMEM_LIMIT; otherwise the first float32 chunk size of
    ``tms`` whose layout fits. Raises, naming the bytes, where none fits:
    no layer falls back to a plain version on the card."""
    shd = sh_dim(irreps_sh)
    need = []
    if tc:
        lay = tp_layout(irreps_in, irreps_out, irreps_sh, TNC)
        b = engine_smem_bytes(shd, TM, d, lay.n_x, rt, True, len(lay.cg), len(lay.epi), lay.n_tiles)
        b += engine_static_bytes(TM, True)
        if d.H <= KMAX and b <= SMEM_LIMIT:
            return True, TM
        need.append(f"tensor cores {b} B (H={d.H}, at most {KMAX})")
    S = tp_layout(irreps_in, irreps_out, irreps_sh).n_x
    for tm in tms:
        b = engine_smem_bytes(shd, tm, d, S, rt) + engine_static_bytes(tm, False)
        if b <= SMEM_LIMIT:
            return False, tm
        need.append(f"float32 at {tm} edges a chunk {b} B")
    raise ValueError(f"{what}: no build of the kernel fits {irreps_in} -> {irreps_out} in {SMEM_LIMIT} bytes of "
                     f"shared memory ({', '.join(need)})")


@functools.lru_cache(maxsize=None)
def device_tables(irreps_in: str, irreps_out: str, device: torch.device, irreps_sh: str = SH_IRREPS, tn: int = TN):
    """(xtab, cg, epi, epi_start, perm, scale) of tp_layout on ``device``."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh, tn)
    return tuple(
        torch.as_tensor(a, device=device) for a in (lay.xtab, lay.cg, lay.epi, lay.epi_start, lay.perm, lay.scale)
    )


class PackedWeights(NamedTuple):
    """An edge MLP's weights in the kernels' layout."""

    w1: torch.Tensor  # [F, H], contiguous float32
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, Wpad]: columns permuted, scaled by 1/sqrt(fan), zero-padded
    b2: torch.Tensor  # [Wpad]
    w2_hi: torch.Tensor  # tile_w2 of tf32(w2), TNC-column tiles: [n_tiles, TNC/8, Hp/4, 8, 4]
    w2_lo: torch.Tensor  # tile_w2 of tf32(w2 - tf32(w2))
    b2_tc: torch.Tensor  # [n_tiles * TNC]: b2 padded to TNC-column tiles


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds it: to nearest, ties away from zero; the low 13 bits are zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to about
    2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tile_w2(w: torch.Tensor, tn: int = TNC) -> torch.Tensor:
    """[H, Wpad] (Wpad a multiple of tn) -> [Wpad / tn, tn / 8, Hp / 4, 8, 4]:
    each tile's columns in core matrices of 8 columns x 4 k, the k-major
    shared-memory layout wgmma reads, H padded with zero rows to Hp."""
    H, wpad = w.shape
    hp = -(-H // 8) * 8
    wk = torch.zeros(wpad, hp, dtype=w.dtype, device=w.device)
    wk[:, :H] = w.t()
    return wk.reshape(wpad // tn, tn // 8, 8, hp // 4, 4).permute(0, 1, 3, 2, 4).contiguous()


@torch.no_grad()
def pack_weights(w1, b1, w2, b2, irreps_in: str, irreps_out: str, irreps_sh: str = SH_IRREPS) -> PackedWeights:
    """Edge-MLP weights (Flax's [in, out] layout) in the kernels' layout,
    for the float32 stage (w2, b2) and the tensor-core stage (w2_hi, w2_lo,
    b2_tc). Constant at inference: ``TPConv.packed_weights`` makes them once
    per edge group; a wrapper called without them makes them per launch."""
    perm, scale = device_tables(irreps_in, irreps_out, w2.device, irreps_sh)[4:]
    H = w2.shape[0]
    w2c = w2.index_select(1, perm) * scale
    b2c = b2.index_select(0, perm) * scale
    padded = []
    for tn in (TN, TNC):
        lay = tp_layout(irreps_in, irreps_out, irreps_sh, tn)
        w2p = torch.zeros(H, lay.wpad, dtype=torch.float32, device=w2.device)
        w2p[:, : lay.weight_numel] = w2c
        b2p = torch.zeros(lay.wpad, dtype=torch.float32, device=b2.device)
        b2p[: lay.weight_numel] = b2c
        padded.append((w2p, b2p))
    (w2p, b2p), (w2t, b2t) = padded
    hi, lo = split_tf32(w2t)
    return PackedWeights(w1.float().contiguous(), b1.float().contiguous(), w2p, b2p, tile_w2(hi), tile_w2(lo), b2t)


def launch_weights(w1, b1, w2, b2, irreps_in: str, irreps_out: str, packed, device,
                   irreps_sh: str = SH_IRREPS) -> PackedWeights:
    """The kernel-layout weights a launch reads: ``packed`` checked against
    the edge MLP's shapes and ``device``, or made now when it is None."""
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, irreps_in, irreps_out, irreps_sh)
    H, wpad = w2.shape[0], tp_layout(irreps_in, irreps_out, irreps_sh).wpad
    wpad_tc = tp_layout(irreps_in, irreps_out, irreps_sh, TNC).wpad
    tiles = (wpad_tc // TNC, TNC // 8, -(-H // 8) * 2, 8, 4)
    if (tuple(packed.w1.shape) != tuple(w1.shape) or tuple(packed.b1.shape) != (H,)
            or tuple(packed.w2.shape) != (H, wpad) or tuple(packed.b2.shape) != (wpad,)
            or tuple(packed.w2_hi.shape) != tiles or tuple(packed.w2_lo.shape) != tiles
            or tuple(packed.b2_tc.shape) != (wpad_tc,)):
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
                  irreps_sh: str = SH_IRREPS, dmask=None) -> torch.Tensor:
    """Per-edge messages [..., Dout]: edge MLP (dmask, when given, after the
    ReLU) -> TP weights -> weighted TP; masked edges exactly zero. w1 [F, H]
    and w2 [H, W] as Flax stores them."""
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    h = torch.relu(eattr @ w1 + b1)
    if dmask is not None:
        h = h * dmask
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


def check_dmask(dmask, lead: tuple, H: int, device: torch.device):
    """A hidden-layer dropout mask lead + (H',) (H' in {1, H}), checked as a
    kernel input; None passes through."""
    if dmask is None:
        return None
    check_inputs(device, floats=(dmask,))
    if tuple(dmask.shape[:-1]) != tuple(lead) or dmask.shape[-1] not in (1, H):
        raise ValueError(f"dropout mask of shape {tuple(dmask.shape)} for edges {tuple(lead)} and H={H}")
    return dmask


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
