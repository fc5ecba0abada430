"""TP-conv kernels of the general route (``csrc/tpconv_rec_g.cu``,
``csrc/tpconv_cross_g.cu``).

Replace ``confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py`` at inference:
the all-atom models' path at lmax=2, and every layer that is not the lmax=1
irreps ladder (the residue-level model at lmax=2, the second-order ladder at
lmax=1; ``tpconv_common.general_route``):

* ``fused_tpconv_rec_g``: message sums [B, N, Dout] of a kNN group whose
  senders and receivers are one node table (receptor <- receptor, atom <-
  atom), with the neighbour gather, the harmonics, the [emb + sig | recv
  scalars | send scalars] edge MLP, the weighted TP and the masked K-sum in
  one kernel.
* ``fused_tpconv_cross_g``: message sums [B, L, Dout] of ligand receivers
  over a capped list of senders from another table (ligand <- receptor,
  ligand <- atom); the edge embedding already holds the sigma embedding.

The Pallas kernels take any mul-1 harmonics up to l=2; these take
``1x0e + 1x1o + 1x2e`` or ``1x0e + 1x1o`` (``tpconv_common.sh_dim``: each
kernel is built at 9 and at 4 harmonic components), and input and output
irreps of l <= 2. Positions stay float32 (the Pallas
kernels split them into bf16 halves, about 1e-4 from a float32 composition).
What bounds the kernels and how they are laid out: ``csrc/tpconv_engine.cuh``.
Both inference kernels run the H -> W product on the tensor cores (3xTF32
``wgmma``) from the split, tiled w2 fields of ``pack_weights``; a layer that
stage does not take runs a float32 build (rec_g at TM_WIDE edges a chunk,
cross_g at TM, else TM_WIDE), and ``fused_tpconv_rec_g``'s training variant
runs the tensor-core stage where the layer fits it, else the float32 stage at
TM edges a chunk (``rec_g_build``, ``tpconv_common.pick_build``; where no
build fits a layer the wrapper raises). Each wrapper launches its kernel
for CUDA tensors, calls its ``*_plain`` version for CPU tensors, and counts launches in ``<wrapper>.launches``. In
training, ``fused_tpconv_rec_g``'s ``dmask`` (the hidden-layer dropout mask)
selects the kernel's training variant (``tpconv_rec_g_dm_tc_kernel``, or
``tpconv_rec_g_dm_kernel`` on the float32 stage at TM or TM_WIDE edges a
chunk), counted apart in
``fused_tpconv_rec_g.dm_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..graph_builders import gather_nodes
from . import build
from .tpconv_common import (TM, TM_WIDE, TNC, Dims, block_width, check_dmask, check_inputs, device_tables,
                            edge_messages, launch_weights, pick_build, ptr, sh_dim, sh_kernel, tp_layout)

RT_REC = 8  # receivers per rec_g block: 8 * K=24 receptor or K=8 atom neighbours

_P, _I = ctypes.c_void_p, ctypes.c_int
_REC_ARGTYPES = [_P] * 15 + [_I] * 16 + [_P, _P]
_REC_WIDE_ARGTYPES = [_P] * 14 + [_I] * 13 + [_P, _P]
_REC_DM_ARGTYPES = [_P] * 7 + [_I] + [_P] * 8 + [_I] * 14 + [_P, _P]
_REC_DM_TC_ARGTYPES = [_P] * 7 + [_I] + [_P] * 9 + [_I] * 16 + [_P, _P]
_CROSS_ARGTYPES = [_P] * 15 + [_I] * 14 + [_P, _P]  # row 4's; cross_g's take one more int, the harmonic width
_CROSS_TC_ARGTYPES = [_P] * 16 + [_I] * 15 + [_P, _P]
_GENERAL_SHD = (4, 9)  # the harmonic widths rec_g and cross_g are built at


def cross_rows_per_block(K: int, chunk: int = TM) -> int:
    """Receivers per block of a list of K senders each (the cross kernels,
    the edge-list kernel): enough to fill a chunk of ``chunk`` edges."""
    return max(1, chunk // max(K, 1))


def rec_g_build(irreps_in: str, irreps_sh: str, irreps_out: str, Fe: int, ns: int, H: int, dropout: bool) -> tuple:
    """(tensor cores?, edges a chunk): the build ``fused_tpconv_rec_g`` runs
    at this layer, with (``dropout``) or without the dropout mask
    (``tpconv_common.pick_build``: the tensor-core stage where the layer
    fits it, else the inference kernel's float32 build at TM_WIDE edges a
    chunk, the training variant's at TM, then TM_WIDE)."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    d = Dims(Fe, ns, Fe + 2 * ns, H, lay.din, lay.dout)
    return pick_build("fused_tpconv_rec_g", irreps_in, irreps_out, irreps_sh, d, RT_REC, True,
                      (TM, TM_WIDE) if dropout else (TM_WIDE,))


def tpconv_rec_g_plain(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out,
                       ns, dmask=None):
    """The same function in plain PyTorch: gather, harmonics, edge MLP
    (dropout mask after the ReLU), weighted TP, masked sum over K."""
    sender = gather_nodes(node_attr, nbr)  # [B, N, K, Din]
    vec = gather_nodes(pos, nbr) - pos[:, :, None, :]
    scal = node_attr[..., :ns]
    eattr = torch.cat(
        [edge_emb + sig[:, None, None, :], scal[:, :, None, :].expand_as(sender[..., :ns]), sender[..., :ns]], dim=-1
    )
    return edge_messages(eattr, sender, sh_kernel(vec, irreps_sh), mask, w1, b1, w2, b2, irreps_in, irreps_out,
                         irreps_sh, dmask).sum(dim=-2)


def tpconv_cross_g_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                         irreps_in, irreps_sh, irreps_out, ns):
    """The same function in plain PyTorch (the JAX package's XLA path)."""
    sender = gather_nodes(src_attr, idx)  # [B, L, K, Dr]
    vec = gather_nodes(src_pos, idx) - recv_pos[:, :, None, :]
    rscal = recv_attr[..., :ns][:, :, None, :].expand_as(sender[..., :ns])
    eattr = torch.cat([edge_emb, rscal, sender[..., :ns]], dim=-1)
    return edge_messages(eattr, sender, sh_kernel(vec, irreps_sh), mask, w1, b1, w2, b2, irreps_in, irreps_out,
                         irreps_sh).sum(dim=-2)


def fused_tpconv_rec_g(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in: str, irreps_sh: str,
                       irreps_out: str, ns: int, packed=None, dmask=None):
    """Message sums [B, N, Dout].

    node_attr [B, N, Din] (canonical irreps layout, senders and receivers),
    pos [B, N, 3], nbr [B, N, K] int64, edge_emb [B, N, K, Fe], sig [B, Fe]
    (added to edge_emb; zeros to skip), mask [B, N, K] bool; w1 [Fe + 2 ns, H],
    b1 [H], w2 [H, W], b2 [W] in Flax's [in, out] layout; ``packed``: the same
    weights from ``pack_weights(..., irreps_sh)`` (made per launch when None);
    ``dmask``: None, or [B, N, K, H'] float32 ({0, 1/keep}, H' in {1, H})."""
    if node_attr.device.type == "cpu":
        return tpconv_rec_g_plain(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_sh,
                                  irreps_out, ns, dmask)
    out = _launch_rec_g(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out,
                        ns, packed, dmask)
    if dmask is None:
        fused_tpconv_rec_g.launches += 1
    else:
        fused_tpconv_rec_g.dm_launches += 1
    return out


def _launch_rec_g(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, ns,
                  packed, dmask=None):
    dev = node_attr.device
    shd = sh_dim(irreps_sh)
    if shd not in _GENERAL_SHD:
        raise ValueError(f"fused_tpconv_rec_g runs lmax=1 or lmax=2 harmonics, got {irreps_sh}")
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    B, N, Din = node_attr.shape
    K, Fe, H = nbr.shape[2], edge_emb.shape[-1], w2.shape[0]
    check_inputs(dev, floats=(node_attr, pos, edge_emb, sig), longs=(nbr,), bools=(mask,))
    if (Din != lay.din or pos.shape != (B, N, 3) or nbr.shape != (B, N, K) or edge_emb.shape[:3] != (B, N, K)
            or sig.shape != (B, Fe) or mask.shape != (B, N, K) or tuple(w1.shape) != (Fe + 2 * ns, H)
            or tuple(w2.shape) != (H, lay.weight_numel)):
        raise ValueError("fused_tpconv_rec_g: inconsistent shapes")
    dm = check_dmask(dmask, (B, N, K), H, dev)
    tc, cm = rec_g_build(irreps_in, irreps_sh, irreps_out, Fe, ns, H, dm is not None)
    pw = launch_weights(w1, b1, w2, b2, irreps_in, irreps_out, packed, dev, irreps_sh)
    out = torch.empty(B, N, lay.dout, dtype=torch.float32, device=dev)
    lib = build.load("tpconv_rec_g")
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (B, N, K, Fe, ns, H, Din, lay.dout, RT_REC, shd, ptr(out), stream)
    inputs = (ptr(node_attr), ptr(pos), ptr(nbr), ptr(edge_emb), ptr(sig), ptr(mask))
    if tc:
        tcl = tp_layout(irreps_in, irreps_out, irreps_sh, TNC)
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, irreps_sh, TNC)[:4]
        tables = (ptr(pw.w1), ptr(pw.b1), ptr(pw.w2_hi), ptr(pw.w2_lo), ptr(pw.b2_tc), ptr(xtab), ptr(cg), ptr(epi),
                  ptr(epi_start), tcl.n_x, tcl.n_tiles, tcl.wpad, len(tcl.epi), len(tcl.cg), *dims[:-2],
                  block_width(irreps_in), *dims[-2:])
        if dm is None:
            fn = lib.cbt_tpconv_rec_g
            fn.argtypes, fn.restype = _REC_ARGTYPES, ctypes.c_int
            code = fn(*inputs, *tables)
        else:
            fn = lib.cbt_tpconv_rec_g_dm_tc
            fn.argtypes, fn.restype = _REC_DM_TC_ARGTYPES, ctypes.c_int
            code = fn(*inputs, ptr(dm), dm.shape[-1], *tables)
        build.check(lib, code, "tpconv_rec_g")
        return out
    xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, irreps_sh)[:4]
    tables = (ptr(pw.w1), ptr(pw.b1), ptr(pw.w2), ptr(pw.b2), ptr(xtab), ptr(cg), ptr(epi), ptr(epi_start), lay.n_x,
              lay.n_tiles, lay.wpad, *dims)
    if dm is None:
        fn = lib.cbt_tpconv_rec_g_wide
        fn.argtypes, fn.restype = _REC_WIDE_ARGTYPES, ctypes.c_int
        code = fn(*inputs, *tables)
    else:
        fn = lib.cbt_tpconv_rec_g_dm
        fn.argtypes, fn.restype = _REC_DM_ARGTYPES, ctypes.c_int
        code = fn(*inputs, ptr(dm), dm.shape[-1], *tables[:-3], cm, *tables[-3:])
    build.check(lib, code, "tpconv_rec_g")
    return out


fused_tpconv_rec_g.launches = 0
fused_tpconv_rec_g.dm_launches = 0


def fused_tpconv_cross_g(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                         irreps_in: str, irreps_sh: str, irreps_out: str, ns: int, packed=None):
    """Message sums [B, L, Dout] of the receivers over their capped senders.

    recv_attr [B, L, D] receivers, recv_pos [B, L, 3], src_attr [B, N, D]
    sender table, src_pos [B, N, 3], idx [B, L, K] int64, edge_emb
    [B, L, K, Fe], mask [B, L, K] bool; weights as in ``fused_tpconv_rec_g``.
    The kernel reads both tables at the TP's input width D."""
    if recv_attr.device.type == "cpu":
        return tpconv_cross_g_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                                    irreps_in, irreps_sh, irreps_out, ns)
    out = _launch_cross_g(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                          irreps_in, irreps_sh, irreps_out, ns, packed)
    fused_tpconv_cross_g.launches += 1
    return out


def _launch_cross_g(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                    irreps_in, irreps_sh, irreps_out, ns, packed):
    if sh_dim(irreps_sh) not in _GENERAL_SHD:
        raise ValueError(f"fused_tpconv_cross_g runs lmax=1 or lmax=2 harmonics, got {irreps_sh}")
    return launch_cross("tpconv_cross_g", recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                        irreps_in, irreps_sh, irreps_out, ns, packed)


def cross_build(kernel: str, irreps_in: str, irreps_out: str, irreps_sh: str, Fe: int, ns: int, H: int,
                K: int) -> tuple:
    """(tensor cores?, edges a chunk): the build ``launch_cross`` runs for
    ``kernel`` at this layer and K senders a receiver
    (``tpconv_common.pick_build``)."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    d = Dims(Fe, ns, Fe + 2 * ns, H, lay.din, lay.dout)
    return pick_build(kernel, irreps_in, irreps_out, irreps_sh, d, cross_rows_per_block(K), True)


def launch_cross(kernel: str, recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                 irreps_in, irreps_sh, irreps_out, ns, packed):
    """Launch ``csrc/<kernel>.cu``, a one-direction cross kernel of the
    ``irreps_sh`` harmonics (``tpconv_cross_g``: lmax=2 or 1, its host
    functions take the harmonic width; ``tpconv_cross``: lmax=1; both
    ``cross_tile`` of the engine), after checking its inputs, on
    the build ``cross_build`` picks: the tensor-core stage where the layer
    fits it, else the float32 build at TM, then TM_WIDE edges a chunk.
    Receivers a block: ``cross_rows_per_block`` (by scripts/engine_ablation.py
    on an H100 at 700 W: row 4's RT=1 at the evaluator's K=100 the fastest
    of RT 1-12 at B = 8 and 32; cross_g's RT=2 at the rerank's K=32 within 2%
    of the fastest RT and its RT=1 at K=64 within 4%, at B=32). Returns the
    sums [B, L, Dout]."""
    dev = recv_attr.device
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    B, L, D = recv_attr.shape
    N, K, Fe, H = src_attr.shape[1], idx.shape[2], edge_emb.shape[-1], w2.shape[0]
    check_inputs(dev, floats=(recv_attr, recv_pos, src_attr, src_pos, edge_emb), longs=(idx,), bools=(mask,))
    if (D != lay.din or src_attr.shape != (B, N, D) or recv_pos.shape != (B, L, 3) or src_pos.shape != (B, N, 3)
            or idx.shape != (B, L, K) or edge_emb.shape[:3] != (B, L, K) or mask.shape != (B, L, K)
            or tuple(w1.shape) != (Fe + 2 * ns, H) or tuple(w2.shape) != (H, lay.weight_numel)):
        raise ValueError(f"{kernel}: inconsistent shapes")
    tc, cm = cross_build(kernel, irreps_in, irreps_out, irreps_sh, Fe, ns, H, K)
    rt = cross_rows_per_block(K, cm)
    pw = launch_weights(w1, b1, w2, b2, irreps_in, irreps_out, packed, dev, irreps_sh)
    out = torch.empty(B, L, lay.dout, dtype=torch.float32, device=dev)
    lib = build.load(kernel)
    inputs = (ptr(recv_attr), ptr(recv_pos), ptr(src_attr), ptr(src_pos), ptr(idx), ptr(edge_emb), ptr(mask))
    dims = (B, L, N, K, Fe, ns, H, D, lay.dout, rt)
    shd = (sh_dim(irreps_sh),) if kernel == "tpconv_cross_g" else ()  # row 4's host functions take neither
    di = (block_width(irreps_in),) if kernel == "tpconv_cross_g" else ()
    extra = [_I] * len(shd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tc:
        tcl = tp_layout(irreps_in, irreps_out, irreps_sh, TNC)
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, irreps_sh, TNC)[:4]
        fn = getattr(lib, "cbt_" + kernel + "_tc")
        fn.argtypes, fn.restype = _CROSS_TC_ARGTYPES[:-2] + 2 * extra + _CROSS_TC_ARGTYPES[-2:], ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2_hi), ptr(pw.w2_lo), ptr(pw.b2_tc), ptr(xtab), ptr(cg),
                  ptr(epi), ptr(epi_start), tcl.n_x, tcl.n_tiles, tcl.wpad, len(tcl.epi), len(tcl.cg), *dims, *shd,
                  *di, ptr(out), stream)
    else:
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, irreps_sh)[:4]
        fn = getattr(lib, "cbt_" + kernel)
        fn.argtypes, fn.restype = _CROSS_ARGTYPES[:-2] + extra + _CROSS_ARGTYPES[-2:], ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2), ptr(pw.b2), ptr(xtab), ptr(cg), ptr(epi),
                  ptr(epi_start), lay.n_x, lay.n_tiles, lay.wpad, *dims, cm, *shd, ptr(out), stream)
    build.check(lib, code, kernel)
    return out


fused_tpconv_cross_g.launches = 0
