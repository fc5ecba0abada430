"""Receptor <- receptor kNN TP-conv (kernel ``csrc/tpconv_rec.cu``).

Replaces ``confidence_bootstrapping_tpu/ops/pallas/tpconv_rec.py:
fused_tpconv_rec``: message sums [B, N, Dout] of a kNN node group whose
senders and receivers are the same node set, with the neighbour gather, the
lmax=1 harmonics, the [emb + sig | recv scalars | send scalars] edge MLP, the
weighted TP and the masked K-sum in one kernel. What bounds it and how the
kernel is laid out: ``csrc/tpconv_engine.cuh``.

``fused_tpconv_rec`` launches the kernel for CUDA tensors and calls
``tpconv_rec_plain`` for CPU tensors; ``fused_tpconv_rec.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..graph_builders import gather_nodes
from . import build
from .tpconv_common import check_inputs, device_tables, edge_messages, launch_weights, ptr, sh1, tp_layout

RT = 8  # receivers per block: 8 * K=24 neighbours fill three 64-edge chunks

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 14 + [_I] * 12 + [_P, _P]


def tpconv_rec_plain(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns):
    """The same function in plain PyTorch: gather, harmonics, edge MLP,
    weighted TP, masked sum over K."""
    sender = gather_nodes(node_attr, nbr)  # [B, N, K, Din]
    vec = gather_nodes(pos, nbr) - pos[:, :, None, :]
    scal = node_attr[..., :ns]
    eattr = torch.cat(
        [edge_emb + sig[:, None, None, :], scal[:, :, None, :].expand_as(sender[..., :ns]), sender[..., :ns]], dim=-1
    )
    return edge_messages(eattr, sender, sh1(vec), mask, w1, b1, w2, b2, irreps_in, irreps_out).sum(dim=-2)


def fused_tpconv_rec(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str, ns: int,
                     packed=None):
    """Message sums [B, N, Dout].

    node_attr [B, N, Din] (canonical irreps layout), pos [B, N, 3],
    nbr [B, N, K] int64, edge_emb [B, N, K, Fe], sig [B, Fe] (added to
    edge_emb; zeros to skip), mask [B, N, K] bool; w1 [Fe + 2 ns, H], b1 [H],
    w2 [H, W], b2 [W] in Flax's [in, out] layout; ``packed``: the same
    weights from ``pack_weights`` (made per launch when None)."""
    if node_attr.device.type == "cpu":
        return tpconv_rec_plain(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns)
    out = _launch(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns, packed)
    fused_tpconv_rec.launches += 1
    return out


def _launch(node_attr, pos, nbr, edge_emb, sig, mask, w1, b1, w2, b2, irreps_in, irreps_out, ns, packed):
    dev = node_attr.device
    lay = tp_layout(irreps_in, irreps_out)
    B, N, Din = node_attr.shape
    K, Fe, H = nbr.shape[2], edge_emb.shape[-1], w2.shape[0]
    check_inputs(dev, floats=(node_attr, pos, edge_emb, sig), longs=(nbr,), bools=(mask,))
    if (Din != lay.din or pos.shape != (B, N, 3) or nbr.shape != (B, N, K) or edge_emb.shape[:3] != (B, N, K)
            or sig.shape != (B, Fe) or mask.shape != (B, N, K) or tuple(w1.shape) != (Fe + 2 * ns, H)
            or tuple(w2.shape) != (H, lay.weight_numel)):
        raise ValueError("fused_tpconv_rec: inconsistent shapes")
    xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev)[:4]
    w1c, b1c, w2p, b2p = launch_weights(w1, b1, w2, b2, irreps_in, irreps_out, packed, dev)
    out = torch.empty(B, N, lay.dout, dtype=torch.float32, device=dev)
    lib = build.load("tpconv_rec")
    fn = lib.cbt_tpconv_rec
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        ptr(node_attr), ptr(pos), ptr(nbr), ptr(edge_emb), ptr(sig), ptr(mask), ptr(w1c), ptr(b1c), ptr(w2p),
        ptr(b2p), ptr(xtab), ptr(cg), ptr(epi), ptr(epi_start), lay.n_x, lay.n_tiles, lay.wpad, B, N, K, Fe, ns, H,
        Din, lay.dout, RT, ptr(out), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "tpconv_rec")
    return out


fused_tpconv_rec.launches = 0
