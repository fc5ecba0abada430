"""Edge-list TP-conv (kernel ``csrc/tpconv_edge.cu``).

Replaces ``confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:
fused_tpconv_nbr_g`` and ``fused_tpconv_msgs_g`` (``_call_g``, with the
training variant's hidden-layer dropout mask): the edge MLP, the weighted TP
and the mask over pre-gathered edge lists [M, K, *], then the sum over K
(``sum_k``, [M, Dout], ``nbr_g``) or each edge's message ([M, K, Dout],
``msgs_g``), in the canonical irreps layout. It is the forward of every
training TP-conv but the receptor kNN groups (``ops/cuda/tpconv_train.py``),
and at inference the general route's edge lists (the ligand pairs and the
receptor <- ligand lists of the residue-level model at lmax=2 and of the
second-order ladder). The harmonics come in as input: widths 4, 9 or 20
(``tpconv_common.sh_dim``); sender and output blocks of l <= 2.
A layer with H <= KMAX = 96 whose layout fits (the score model's ns=32
ladder, its center and torsion convolutions) runs the kernel's tensor-core
build (3xTF32 ``wgmma``, from the split, tiled w2 fields of
``pack_weights``); the others run the float32 build at 64 edges a chunk, or
at 32 where 64 does not fit (the ns=48 ladder's wider layers)
(``tpconv_common.pick_build``); where no build fits, the wrapper raises.

``fused_tpconv_edge`` launches the kernel for CUDA tensors and calls
``tpconv_edge_plain`` for CPU tensors; ``fused_tpconv_edge.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .tpconv_common import (TNC, Dims, block_width, check_inputs, device_tables, edge_messages, launch_weights,
                            pick_build, ptr, sh_dim, tp_layout)
from .tpconv_g import cross_rows_per_block

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] + [_P] * 8 + [_I] * 13 + [_P, _P]
_TC_ARGTYPES = [_P] * 5 + [_I] + [_P] * 9 + [_I] * 15 + [_P, _P]


def edge_build(irreps_in: str, irreps_sh: str, irreps_out: str, F: int, H: int, K: int) -> tuple:
    """(tensor cores?, edges a chunk): the build the edge-list kernel runs
    for lists of K edges at this layer (``tpconv_common.pick_build``)."""
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    d = Dims(F, 0, F, H, lay.din, lay.dout)
    return pick_build("fused_tpconv_edge", irreps_in, irreps_out, irreps_sh, d, cross_rows_per_block(K), True)


def tpconv_edge_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, dmask=None,
                      sum_k=True):
    """The same function in plain PyTorch (the JAX package's XLA path)."""
    msg = edge_messages(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out, irreps_sh, dmask)
    return msg.sum(dim=-2) if sum_k else msg


def fused_tpconv_edge(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_sh: str, irreps_out: str,
                      dmask=None, sum_k: bool = True, packed=None):
    """Message sums [M, Dout] (sum_k) or per-edge messages [M, K, Dout].

    edge_attr [M, K, F] (the whole MLP input), sender [M, K, Din], sh
    [M, K, Dsh], mask [M, K] bool, dmask None or [M, K, H'] float32 (H' in
    {1, H}; values {0, 1/keep}); w1 [F, H], b1, w2 [H, W], b2 in Flax's
    [in, out] layout; ``packed``: the same weights from ``pack_weights``."""
    if edge_attr.device.type == "cpu":
        return tpconv_edge_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out,
                                 dmask, sum_k)
    out = launch_edges(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, dmask, sum_k,
                       packed)
    fused_tpconv_edge.launches += 1
    return out


def launch_edges(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, dmask, sum_k, packed):
    """Check the inputs and launch the edge-list kernel; counts nothing (the
    callers count their own launches)."""
    dev = edge_attr.device
    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    M, K, F = edge_attr.shape
    H, dsh = w2.shape[0], sh_dim(irreps_sh)
    check_inputs(dev, floats=(edge_attr, sender, sh) + (() if dmask is None else (dmask,)), bools=(mask,))
    hd = 0 if dmask is None else dmask.shape[-1]
    if (sender.shape != (M, K, lay.din) or sh.shape != (M, K, dsh) or mask.shape != (M, K)
            or tuple(w1.shape) != (F, H) or tuple(w2.shape) != (H, lay.weight_numel)
            or (dmask is not None and (dmask.shape[:2] != (M, K) or hd not in (1, H)))):
        raise ValueError("fused_tpconv_edge: inconsistent shapes")
    tc, cm = edge_build(irreps_in, irreps_sh, irreps_out, F, H, K)
    pw = launch_weights(w1, b1, w2, b2, irreps_in, irreps_out, packed, dev, irreps_sh)
    shape = (M, lay.dout) if sum_k else (M, K, lay.dout)
    out = (torch.empty if sum_k else torch.zeros)(shape, dtype=torch.float32, device=dev)
    lib = build.load("tpconv_edge")
    inputs = (ptr(edge_attr), ptr(sender), ptr(sh), ptr(mask), ptr(dmask), hd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tc:
        tcl = tp_layout(irreps_in, irreps_out, irreps_sh, TNC)
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, irreps_sh, TNC)[:4]
        fn = lib.cbt_tpconv_edge_tc
        fn.argtypes, fn.restype = _TC_ARGTYPES, ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2_hi), ptr(pw.w2_lo), ptr(pw.b2_tc), ptr(xtab), ptr(cg),
                  ptr(epi), ptr(epi_start), tcl.n_x, tcl.n_tiles, tcl.wpad, len(tcl.epi), len(tcl.cg), M, K, F, H,
                  lay.din, lay.dout, dsh, cross_rows_per_block(K), int(sum_k), block_width(irreps_in), ptr(out),
                  stream)
    else:
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, irreps_sh)[:4]
        fn = lib.cbt_tpconv_edge
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2), ptr(pw.b2), ptr(xtab), ptr(cg), ptr(epi),
                  ptr(epi_start), lay.n_x, lay.n_tiles, lay.wpad, M, K, F, H, lay.din, lay.dout, dsh,
                  cross_rows_per_block(K, cm), int(sum_k), cm, ptr(out), stream)
    build.check(lib, code, "tpconv_edge")
    return out


fused_tpconv_edge.launches = 0
