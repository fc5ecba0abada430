"""Edge backward of the TP-conv training ops (kernel ``csrc/tpconv_bwd.cu``).

Replaces ``confidence_bootstrapping_tpu/ops/pallas/tpconv_bwd.py:
edge_bwd_pallas``: given per-edge MLP inputs, senders, harmonics, the
cotangent of the per-edge messages (canonical irreps layout, zero on masked
edges) and the dropout mask, it returns the per-edge gradients (d_attr,
d_sender, d_sh) and the edge MLP's weight gradients summed over every edge
(dW1, db1, dW2, db2, in Flax's [in, out] layout). The math is the hand-derived
VJP of ``ops/pallas/tpconv_train.py`` (recompute h, then d_w, dh, the CG
contributions' cotangent, the MLP backward); the layout is this repository's
(``bwd_layout``), not the TPU kernel's G/E/R matrices.

``edge_bwd`` launches the kernel for CUDA tensors and calls ``edge_bwd_plain``
(autograd of ``tpconv_edge.tpconv_edge_plain``) for CPU tensors;
``edge_bwd.launches`` counts kernel launches. A layer with H <= 96 whose
layout fits a block (``bwd_on_tensor_cores``: the score model's ns=32 ladder)
takes the tensor-core build: the edges the caller marks ``valid`` (all of
them when it passes None) are numbered in order on the device, masked edges
get zero per-edge gradients and add nothing, and the three H x W products
(recompute, dh, the weight-gradient reduction) run on 3xTF32 ``wgmma``.
Other layers take the float32 per-edge kernel on every edge, whose two
builds (``bwd_build``) hold 32 edges a block for H <= 128, and 16 for
H <= 192 or where the 32-edge layout does not fit a block's shared memory;
their weight-gradient reduction is the tensor-core build's, over every edge.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..irreps import Irreps, WeightedTensorProduct
from . import build
from .tpconv_common import KMAX, SMEM_LIMIT, TM, TN, TNC, check_inputs, device_tables, ptr, sh_dim, tp_layout
from .tpconv_edge import tpconv_edge_plain

BUILDS = ((32, 128), (16, 192))  # csrc/tpconv_bwd.cu: (edges a block, the largest H) of each per-edge build
TARGET_BLOCKS = 528  # reduction blocks to aim for: four per SM of an H100
MIN_ROWS_PER_SPLIT = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] + [_P] * 11 + [_I] * 9 + [_P] * 6 + [_I] * 2 + [_P] * 3 + [_I, _P]
_TC_ARGTYPES = [_P] * 5 + [_I] + [_P] * 14 + [_I] * 12 + [_P] * 4 + [_I] * 2 + [_P] * 3
GEMM_TILE = (128, 96)  # csrc/tpconv_bwd.cu: (GM, GN), the output tile of the products
BWD_TC_STATIC = 2768  # static shared memory of the tensor-core per-edge kernel: its rows, barriers and tile tables


class BwdLayout(NamedTuple):
    cscale: np.ndarray  # [W] 1/sqrt(fan) of each canonical w2 column
    bcol: np.ndarray  # [Wpad, 3] int32: x_base, g_base, dout of each column
    bepi: np.ndarray  # [items, 5] int32: col_lo, col_hi, g_base, g_step, x_index
    bepi_start: np.ndarray  # [n_tiles + 1] int32
    vtab: np.ndarray  # [rows, 5] int32: s, vec_base, n, cg_index, cg_stride
    vtab_start: np.ndarray  # [Din + Dsh + 1] int32


@functools.lru_cache(maxsize=None)
def bwd_layout(irreps_in: str, irreps_out: str, irreps_sh: str, tn: int = TN) -> BwdLayout:
    """The backward kernel's tables for ``tn``-column tiles (TN: the float32
    builds, TNC: the tensor-core build). w2 keeps its canonical column order
    (n = ofs_g + u * mul_g + v) with 1/sqrt(fan_g) folded in, so the v of
    one (group g, fan row u) are contiguous: d_X[g, u, c] sums over that
    column segment (one epilogue item per tile it meets and component c),
    and d_w[n] sums over the components c (``bcol``). ``vtab`` lists, per
    sender and harmonic component, the CG terms that carry d_X to it."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh, tn)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    out_sl = tp.irreps_out.slices()
    cscale = np.zeros(lay.weight_numel, np.float32)
    bcol = np.zeros((lay.wpad, 3), np.int32)
    segs = []
    x_off = w_off = 0
    for g in tp.groups:
        mul, ir_out = tp.irreps_out[g.out_index]
        do, fan, oc = ir_out.dim, g.fan_in, out_sl[g.out_index].start
        for u in range(fan):
            n0 = w_off + u * mul
            for v in range(mul):
                cscale[n0 + v] = 1.0 / np.sqrt(fan)
                bcol[n0 + v] = (x_off + u * do, oc + v * do, do)
            segs.append((n0, n0 + mul, oc, do, x_off + u * do))
        x_off += fan * do
        w_off += fan * mul
    bepi, bepi_start = [], [0]
    for t in range(lay.n_tiles):
        t0, t1 = t * tn, (t + 1) * tn
        for n0, n1, oc, do, xb in segs:
            lo, hi = max(n0, t0), min(n1, t1)
            if lo < hi:
                bepi += [(lo - t0, hi - t0, oc + (lo - n0) * do + c, do, xb + c) for c in range(do)]
        bepi_start.append(len(bepi))
    din, dsh = lay.din, Irreps(irreps_sh).dim
    rows = [[] for _ in range(din + dsh)]
    for s, (in_base, di, sh_base, ds, dout, c, cg_off, _) in enumerate(lay.xtab.tolist()):
        for a in range(di):
            rows[in_base + a].append((s, sh_base, ds, cg_off + c + a * ds * dout, dout))
        for b in range(ds):
            rows[din + sh_base + b].append((s, in_base, di, cg_off + c + b * dout, ds * dout))
    vtab = [r for rs in rows for r in rs]
    vtab_start = np.cumsum([0] + [len(rs) for rs in rows])
    return BwdLayout(cscale, bcol, np.asarray(bepi, np.int32).reshape(-1, 5), np.asarray(bepi_start, np.int32),
                     np.asarray(vtab, np.int32).reshape(-1, 5), vtab_start.astype(np.int32))


def bwd_smem_bytes(bt: int, F: int, H: int, Din: int, Dsh: int, Dout: int, S: int) -> int:
    """Dynamic shared memory of one block of the per-edge kernel at ``bt``
    edges a block: the host mirror of ``bwd_layout`` in csrc/tpconv_bwd.cu,
    whose library exports the C++ value (``cbt_bwd_smem_bytes``)."""
    ldw = TN + 1
    region = max(bt * (F | 1), H * ldw + 2 * bt * ldw, bt * (H | 1))
    return 4 * (region + bt * ((Din | 1) + (Dsh | 1) + (Dout | 1) + 2 * (S | 1)) + H * (bt + 1))


@functools.lru_cache(maxsize=None)
def bwd_build(F: int, H: int, Din: int, Dsh: int, Dout: int, S: int) -> int:
    """Edges a block of the per-edge build a layer takes: the first of
    ``BUILDS`` that takes its H and whose layout fits SMEM_LIMIT. Raises,
    naming the bytes, where none does."""
    need = []
    for bt, hmax in BUILDS:
        b = bwd_smem_bytes(bt, F, H, Din, Dsh, Dout, S)
        if H <= hmax and b <= SMEM_LIMIT:
            return bt
        need.append(f"{bt} edges a block: {b} B, H <= {hmax}")
    raise ValueError(f"edge_bwd: no build of the backward kernel takes F={F} H={H} Din={Din} Dout={Dout} S={S} "
                     f"in {SMEM_LIMIT} bytes of shared memory ({'; '.join(need)})")


def bwd_tc_smem_bytes(F: int, H: int, Din: int, Dsh: int, Dout: int, S: int, n_cg: int = 0, n_vtab: int = 0) -> int:
    """Dynamic shared memory of one block of the tensor-core per-edge kernel
    (64 compacted edges; n_cg floats of cg, n_vtab rows of vtab): the host
    mirror of ``bwd_layout_tc`` in csrc/tpconv_bwd.cu, whose library exports
    the C++ value (``cbt_bwd_tc_smem_bytes``)."""
    r4 = lambda x: (x + 3) & ~3
    hp = -(-H // 8) * 8
    ring, cs = 4 * TNC * hp, r4(TM * (TNC + 1))
    transients = r4(TM * (F | 1)) + r4(TM * (Din | 1)) + r4(TM * (Dsh | 1)) + r4(TM * (hp + 4))
    x = r4(max(TM * (S | 1), max(F, TM) * hp, n_vtab * 5 + Din + Dsh + 1 + n_cg))
    dx = r4(max(TM * (S | 1), S * 8 + n_cg))
    return 4 * (max(ring + cs, transients) + x + dx + r4(TM * (Dout | 1)))


@functools.lru_cache(maxsize=None)
def bwd_on_tensor_cores(F: int, H: int, Din: int, Dsh: int, Dout: int, S: int, n_cg: int = 0, n_vtab: int = 0) -> bool:
    """Whether a layer takes the tensor-core build: H <= KMAX and its layout
    (with the kernel's static bytes) within SMEM_LIMIT."""
    return H <= KMAX and bwd_tc_smem_bytes(F, H, Din, Dsh, Dout, S, n_cg, n_vtab) + BWD_TC_STATIC <= SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def _device_bwd_tables(irreps_in: str, irreps_out: str, irreps_sh: str, device: torch.device, tn: int = TN):
    return tuple(torch.as_tensor(a, device=device) for a in bwd_layout(irreps_in, irreps_out, irreps_sh, tn))


def edge_bwd_plain(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out):
    """The same function in plain PyTorch: autograd of the per-edge messages
    against the cotangent g. -> (d_attr, d_sender, d_sh, dW1, db1, dW2, db2)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (attr, sender, sh, w1, b1, w2, b2)]
        a, x, s, *w = leaves
        mask = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
        msg = tpconv_edge_plain(a[:, None], x[:, None], s[:, None], mask[:, None], *w, irreps_in, irreps_sh, irreps_out,
                                None if dmask is None else dmask[:, None], sum_k=False)[:, 0]
        return torch.autograd.grad(msg, leaves, g)


def edge_bwd(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in: str, irreps_sh: str, irreps_out: str,
             valid=None):
    """Per-edge and weight gradients of T edges.

    attr [T, F] (the MLP input), sender [T, Din], sh [T, Dsh], g [T, Dout]
    (canonical layout, zero on masked edges), dmask None or [T, H'] ({0,
    1/keep}, H' in {1, H}); w1 [F, H], b1 [H], w2 [H, W], b2 [W]; valid
    None or [T] bool, the edges g is not masked on (the tensor-core build
    skips the others; the plain version and the float32 builds, which get
    zeros from them anyway, ignore it). Returns (d_attr [T, F], d_sender
    [T, Din], d_sh [T, Dsh], dW1, db1, dW2, db2)."""
    if attr.device.type == "cpu":
        return edge_bwd_plain(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out)
    out = _launch(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, valid)
    edge_bwd.launches += 1
    return out


def reduction_splits(T: int, M: int, N: int) -> int:
    """Slices of T for an [M, N] weight-gradient reduction on GEMM_TILE
    output tiles: enough blocks for TARGET_BLOCKS, at least
    MIN_ROWS_PER_SPLIT rows each."""
    tiles = -(-M // GEMM_TILE[0]) * -(-N // GEMM_TILE[1])
    return max(1, min(-(-TARGET_BLOCKS // tiles), -(-T // MIN_ROWS_PER_SPLIT)))


def _launch(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, valid):
    dev = attr.device
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    T, F = attr.shape
    H, dsh = w2.shape[0], sh_dim(irreps_sh)
    hd = 0 if dmask is None else dmask.shape[-1]
    check_inputs(dev, floats=(attr, sender, sh, g) + (() if dmask is None else (dmask,)))
    if (sender.shape != (T, lay.din) or sh.shape != (T, dsh) or g.shape != (T, lay.dout)
            or tuple(w1.shape) != (F, H) or tuple(w2.shape) != (H, lay.weight_numel)
            or (dmask is not None and (dmask.shape[0] != T or hd not in (1, H)))
            or (valid is not None and tuple(valid.shape) != (T,))):
        raise ValueError("edge_bwd: inconsistent shapes")
    if bwd_on_tensor_cores(F, H, lay.din, dsh, lay.dout, lay.n_x, len(lay.cg),
                           len(bwd_layout(irreps_in, irreps_out, irreps_sh).vtab)):
        if valid is None:
            valid = torch.ones(T, dtype=torch.bool, device=dev)
        check_inputs(dev, bools=(valid,))
        return _launch_tc(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, valid)
    bt = bwd_build(F, H, lay.din, dsh, lay.dout, lay.n_x)
    xtab, cg = device_tables(irreps_in, irreps_out, dev, irreps_sh)[:2]
    cscale, bcol, bepi, bepi_start, vtab, vtab_start = _device_bwd_tables(irreps_in, irreps_out, irreps_sh, dev)
    W = lay.weight_numel
    with torch.no_grad():
        w2c = torch.zeros(H, lay.wpad, dtype=torch.float32, device=dev)
        w2c[:, :W] = w2 * cscale
        b2c = torch.zeros(lay.wpad, dtype=torch.float32, device=dev)
        b2c[:W] = b2 * cscale
        w1c, b1c = w1.float().contiguous(), b1.float().contiguous()
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    d_attr, d_x, d_sh = empty(T, F), empty(T, lay.din), empty(T, dsh)
    hbuf, dhbuf, dwbuf = empty(T, H), empty(T, H), empty(T, lay.wpad)
    s2, s1 = reduction_splits(T, H + 1, lay.wpad), reduction_splits(T, F + 1, H)
    part = empty(max(s2 * (H + 1) * lay.wpad, s1 * (F + 1) * H))
    dw2, dw1 = empty(H + 1, lay.wpad), empty(F + 1, H)
    lib = build.load("tpconv_bwd")
    fn = lib.cbt_tpconv_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        ptr(attr), ptr(sender), ptr(sh), ptr(g), ptr(dmask), hd, ptr(w1c), ptr(b1c), ptr(w2c), ptr(b2c), ptr(xtab),
        ptr(cg), ptr(bcol), ptr(bepi), ptr(bepi_start), ptr(vtab), ptr(vtab_start), T, F, H, lay.din, dsh, lay.dout,
        lay.n_x, lay.n_tiles, lay.wpad, ptr(d_attr), ptr(d_x), ptr(d_sh), ptr(hbuf), ptr(dhbuf), ptr(dwbuf), s2, s1,
        ptr(part), ptr(dw2), ptr(dw1), bt, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "tpconv_bwd")
    return d_attr, d_x, d_sh, dw1[:F], dw1[F], dw2[:H, :W] * cscale, dw2[H, :W] * cscale


def _launch_tc(attr, sender, sh, g, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, valid):
    dev = attr.device
    lay, tcl = tp_layout(irreps_in, irreps_out, irreps_sh), tp_layout(irreps_in, irreps_out, irreps_sh, TNC)
    T, F = attr.shape
    H, dsh, W, wpad = w2.shape[0], sh_dim(irreps_sh), lay.weight_numel, tcl.wpad
    hd = 0 if dmask is None else dmask.shape[-1]
    xtab, cg = device_tables(irreps_in, irreps_out, dev, irreps_sh)[:2]
    cscale, bcol, bepi, bepi_start, vtab, vtab_start = _device_bwd_tables(irreps_in, irreps_out, irreps_sh, dev, TNC)
    with torch.no_grad():
        w1c, b1c, w2c, b2c = (t.float().contiguous() for t in (w1, b1, w2, b2))
        # the valid edges are numbered on the device from their running count: the host never waits for it
        csum = torch.cumsum(valid, 0, dtype=torch.int32)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    d_attr, d_x, d_sh = empty(T, F), empty(T, lay.din), empty(T, dsh)
    dw2, dw1 = empty(H + 1, wpad), empty(F + 1, H)
    s2, s1 = reduction_splits(T, H + 1, wpad), reduction_splits(T, F + 1, H)
    lib = build.load("tpconv_bwd")
    size = lib.cbt_bwd_tc_scratch_floats
    size.argtypes, size.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    scratch = empty(size(T, F, H, wpad, s2, s1))
    fn = lib.cbt_tpconv_bwd_tc
    fn.argtypes, fn.restype = _TC_ARGTYPES, ctypes.c_int
    code = fn(
        ptr(attr), ptr(sender), ptr(sh), ptr(g), ptr(dmask), hd, ptr(valid), ptr(csum), ptr(w1c), ptr(b1c), ptr(w2c),
        ptr(b2c), ptr(cscale), ptr(xtab), ptr(cg), ptr(bcol), ptr(bepi), ptr(bepi_start), ptr(vtab), ptr(vtab_start),
        T, F, H, W, lay.din, dsh, lay.dout, lay.n_x, tcl.n_tiles, wpad, len(lay.cg), len(vtab), ptr(d_attr),
        ptr(d_x), ptr(d_sh), ptr(scratch), s2, s1, ptr(dw2), ptr(dw1), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "tpconv_bwd")
    return d_attr, d_x, d_sh, dw1[:F], dw1[F], dw2[:H, :W] * cscale, dw2[H, :W] * cscale


edge_bwd.launches = 0
