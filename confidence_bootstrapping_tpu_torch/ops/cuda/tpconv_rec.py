"""Receptor <- receptor kNN TP-conv (kernel ``csrc/tpconv_rec.cu``) and the
one-direction cross TP-conv at lmax=1 (kernel ``csrc/tpconv_cross.cu``).

Replace ``confidence_bootstrapping_tpu/ops/pallas/tpconv_rec.py``:

* ``fused_tpconv_rec``: message sums [B, N, Dout] of a kNN node group whose
  senders and receivers are the same node set, with the neighbour gather, the
  lmax=1 harmonics, the [emb + sig | recv scalars | send scalars] edge MLP,
  the weighted TP and the masked K-sum in one kernel.
* ``fused_tpconv_cross``: message sums [B, L, Dout] of ligand receivers over
  a capped list of receptor senders (the edge embedding already holds the
  sigma embedding); the score model's ligand <- receptor group when the cross
  list's K is not a multiple of 16 and ``fused_tpconv_cross_rev`` does not
  take it. Launches are counted in ``fused_tpconv_cross.launches``.

What bounds them and how the kernels are laid out: ``csrc/tpconv_engine.cuh``.
``fused_tpconv_rec``'s inference kernel runs the H -> W product on the tensor
cores (3xTF32 ``wgmma``), reading the split, tiled w2 fields of
``pack_weights`` and the tables of TNC-column tiles; a layer that stage does
not take (H > KMAX = 96, or a layout over a block's shared memory: the
ns=48 ladder) runs its float32 build at TM_WIDE edges a chunk. Its training
variant and ``fused_tpconv_cross`` keep the float32 stage, at TM edges a
chunk or TM_WIDE where TM does not fit (``tpconv_common.pick_build``). Where
no build fits a layer the wrapper raises.

``fused_tpconv_rec`` launches the kernel for CUDA tensors and calls
``tpconv_rec_plain`` for CPU tensors; ``fused_tpconv_rec.launches`` counts
launches of the inference kernel. In training, ``dmask`` (the hidden-layer
dropout mask of every neighbour slot) selects the kernel's training variant
(``tpconv_rec_dm_kernel``), counted apart in ``fused_tpconv_rec.dm_launches``;
without it the inference kernel runs as before.
"""

from __future__ import annotations

import ctypes

import torch

from ..graph_builders import gather_nodes
from . import build
from .tpconv_common import (SH_IRREPS, TM, TM_WIDE, TNC, Dims, check_dmask, check_inputs, device_tables, edge_messages,
                            launch_weights, pick_build, ptr, sh1, tp_layout)
from .tpconv_g import launch_cross, tpconv_cross_g_plain

RT = 8  # receivers per block: 8 * K=24 neighbours fill three 64-edge chunks

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 15 + [_I] * 14 + [_P, _P]
_WIDE_ARGTYPES = [_P] * 14 + [_I] * 12 + [_P, _P]
_DM_ARGTYPES = [_P] * 7 + [_I] + [_P] * 8 + [_I] * 13 + [_P, _P]


def tpconv_rec_plain(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns, dmask=None):
    """The same function in plain PyTorch: gather, harmonics, edge MLP
    (dropout mask after the ReLU), weighted TP, masked sum over K."""
    sender = gather_nodes(node_attr, nbr)  # [B, N, K, Din]
    vec = gather_nodes(pos, nbr) - pos[:, :, None, :]
    scal = node_attr[..., :ns]
    eattr = torch.cat(
        [edge_emb + sig[:, None, None, :], scal[:, :, None, :].expand_as(sender[..., :ns]), sender[..., :ns]], dim=-1
    )
    return edge_messages(eattr, sender, sh1(vec), mask, w1, b1, w2, b2, irreps_in, irreps_out,
                         dmask=dmask).sum(dim=-2)


def fused_tpconv_rec(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str, ns: int,
                     packed=None, dmask=None):
    """Message sums [B, N, Dout].

    node_attr [B, N, Din] (canonical irreps layout), pos [B, N, 3],
    nbr [B, N, K] int64, edge_emb [B, N, K, Fe], sig [B, Fe] (added to
    edge_emb; zeros to skip), mask [B, N, K] bool; w1 [Fe + 2 ns, H], b1 [H],
    w2 [H, W], b2 [W] in Flax's [in, out] layout; ``packed``: the same
    weights from ``pack_weights`` (made per launch when None); ``dmask``:
    None, or [B, N, K, H'] float32 ({0, 1/keep}, H' in {1, H})."""
    if node_attr.device.type == "cpu":
        return tpconv_rec_plain(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns,
                                dmask)
    out = _launch(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns, packed, dmask)
    if dmask is None:
        fused_tpconv_rec.launches += 1
    else:
        fused_tpconv_rec.dm_launches += 1
    return out


def _launch(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns, packed, dmask=None):
    dev = node_attr.device
    lay = tp_layout(irreps_in, irreps_out)
    B, N, Din = node_attr.shape
    K, Fe, H = nbr.shape[2], edge_emb.shape[-1], w2.shape[0]
    check_inputs(dev, floats=(node_attr, pos, edge_emb, sig), longs=(nbr,), bools=(mask,))
    if (Din != lay.din or pos.shape != (B, N, 3) or nbr.shape != (B, N, K) or edge_emb.shape[:3] != (B, N, K)
            or sig.shape != (B, Fe) or mask.shape != (B, N, K) or tuple(w1.shape) != (Fe + 2 * ns, H)
            or tuple(w2.shape) != (H, lay.weight_numel)):
        raise ValueError("fused_tpconv_rec: inconsistent shapes")
    dm = check_dmask(dmask, (B, N, K), H, dev)
    d = Dims(Fe, ns, Fe + 2 * ns, H, Din, lay.dout)
    tc, cm = pick_build("fused_tpconv_rec", irreps_in, irreps_out, SH_IRREPS, d, RT, dm is None,
                        (TM_WIDE,) if dm is None else (TM, TM_WIDE))
    pw = launch_weights(w1, b1, w2, b2, irreps_in, irreps_out, packed, dev)
    out = torch.empty(B, N, lay.dout, dtype=torch.float32, device=dev)
    lib = build.load("tpconv_rec")
    stream = torch.cuda.current_stream(dev).cuda_stream
    inputs = (ptr(node_attr), ptr(pos), ptr(nbr), ptr(edge_emb), ptr(sig), ptr(mask))
    dims = (B, N, K, Fe, ns, H, Din, lay.dout, RT)
    if tc:
        tcl = tp_layout(irreps_in, irreps_out, tn=TNC)
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, tn=TNC)[:4]
        fn = lib.cbt_tpconv_rec
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2_hi), ptr(pw.w2_lo), ptr(pw.b2_tc), ptr(xtab), ptr(cg),
                  ptr(epi), ptr(epi_start), tcl.n_x, tcl.n_tiles, tcl.wpad, len(tcl.epi), len(tcl.cg), *dims,
                  ptr(out), stream)
    else:
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev)[:4]
        tables = (ptr(pw.w1), ptr(pw.b1), ptr(pw.w2), ptr(pw.b2), ptr(xtab), ptr(cg), ptr(epi), ptr(epi_start),
                  lay.n_x, lay.n_tiles, lay.wpad, *dims)
        if dm is None:
            fn = lib.cbt_tpconv_rec_wide
            fn.argtypes, fn.restype = _WIDE_ARGTYPES, ctypes.c_int
            code = fn(*inputs, *tables, ptr(out), stream)
        else:
            fn = lib.cbt_tpconv_rec_dm
            fn.argtypes, fn.restype = _DM_ARGTYPES, ctypes.c_int
            code = fn(*inputs, ptr(dm), dm.shape[-1], *tables, cm, ptr(out), stream)
    build.check(lib, code, "tpconv_rec")
    return out


fused_tpconv_rec.launches = 0
fused_tpconv_rec.dm_launches = 0


def tpconv_cross_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2, irreps_in,
                       irreps_out, ns):
    """The same function in plain PyTorch: gather, lmax=1 harmonics, edge
    MLP, weighted TP, masked sum over K."""
    return tpconv_cross_g_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                                irreps_in, SH_IRREPS, irreps_out, ns)


def fused_tpconv_cross(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                       irreps_in: str, irreps_out: str, ns: int, interpret: bool = False, use_bf16: bool = True,
                       packed=None):
    """Message sums [B, L, Dout] of the receivers over their capped senders.

    recv_attr [B, L, D] receivers, recv_pos [B, L, 3], src_attr [B, N, D]
    sender table, src_pos [B, N, 3], idx [B, L, K] int64, edge_emb
    [B, L, K, Fe] (sigma included), mask [B, L, K] bool; w1 [Fe + 2 ns, H]
    (rows [Fe | ns receiver | ns sender]), b1, w2 [H, W], b2 in Flax's
    [in, out] layout; ``packed``: the same weights from ``pack_weights``.
    ``interpret`` and ``use_bf16`` are the Pallas kernel's and are ignored."""
    if recv_attr.device.type == "cpu":
        return tpconv_cross_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                                  irreps_in, irreps_out, ns)
    out = launch_cross("tpconv_cross", recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1, b1, w2, b2,
                       irreps_in, SH_IRREPS, irreps_out, ns, packed)
    fused_tpconv_cross.launches += 1
    return out


fused_tpconv_cross.launches = 0
