"""Ligand-side TP-conv kernels (``csrc/tpconv_pb.cu``, ``csrc/tpconv_cross_rev.cu``).

Replace ``confidence_bootstrapping_tpu/ops/pallas/tpconv_lig.py``:

* ``fused_tpconv_pb``: ligand <- ligand messages over the dense radius pairs
  plus the bond edges, which share one edge MLP; bond messages are summed
  onto their receiver ``bond_src``. The kernel sums each bond in the block
  that owns its receiver, in edge order, with no atomics.
* ``fused_tpconv_cross_rev``: both directions of the capped cross edge list,
  ligand <- receptor summed over K and receptor <- ligand (its own MLP
  weights, harmonics of the negated vector) scattered onto the receptor
  nodes. The kernel adds the reverse messages with atomicAdd, so their sum
  order varies between runs (a few float32 ulps per receptor row).

What bounds them and how they are laid out: ``csrc/tpconv_engine.cuh``;
both run the H -> W product on the tensor cores (3xTF32 ``wgmma``) from the
split, tiled w2 fields of ``pack_weights``; a layer that stage does not take
(H > KMAX = 96, or a layout over a block's shared memory: the ns=48 ladder)
runs the kernel's float32 build at TM_WIDE edges a chunk
(``tpconv_common.pick_build``), and where no build fits the wrapper raises.
Each wrapper launches its kernel for CUDA tensors, calls its ``*_plain``
version for CPU tensors, and counts launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..graph_builders import gather_nodes, scatter_mean_to_nodes
from . import build
from .tpconv_common import (SH_IRREPS, TM_WIDE, TN, TNC, Dims, check_inputs, device_tables, edge_messages,
                            launch_weights, pick_build, ptr, sh1, tp_layout)

RT_CROSS = 1  # ligand receivers per cross_rev block (K up to 128 edges each)

_P, _I = ctypes.c_void_p, ctypes.c_int
_PB_ARGTYPES = [_P] * 17 + [_I] * 14 + [_P, _P]
_PB_WIDE_ARGTYPES = [_P] * 16 + [_I] * 12 + [_P, _P]
_CROSS_ARGTYPES = [_P] * 17 + [_I] + [_P] * 4 + [_I] * 15 + [_P] * 3
_CROSS_WIDE_ARGTYPES = [_P] * 15 + [_I] + [_P] * 4 + [_I] * 13 + [_P] * 3


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pb_rows_per_block(B: int, L: int, n_sm: int) -> int:
    """Ligand receivers per pb block: the fewest that put the grid
    (B * ceil(L / RT) blocks, one an SM at pb's shared memory) in one wave
    over n_sm SMs, or a whole pose a block when B alone exceeds them. Every
    chunk streams all of w2, so a block's time goes with its chunks: fewer
    receivers a block means fewer and emptier chunks, and the one wave keeps
    a second from doubling the time. On an H100 (132 SMs, L=24; the sample's
    pb calls, scripts/engine_ablation.py) the RT it picks was the fastest of
    RT 2-24 at each batch timed: B=8, RT=2 (0.081 ms a call, next 0.151 at
    RT=3); B=32, RT=6 (0.195, next 0.233 at RT=8); B=64, RT=12 (0.355, next
    0.370 at RT=6)."""
    for rt in range(1, L + 1):
        if B * -(-L // rt) <= n_sm:
            return rt
    return max(L, 1)


def tpconv_pb_plain(lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask,
                    w1, b1, w2, b2, irreps_in, irreps_out, ns):
    """The same function in plain PyTorch (the JAX package's XLA path)."""
    B, L, D = lig_attr.shape
    scal = lig_attr[..., :ns]
    eattr = torch.cat([pair_emb, scal[:, :, None, :].expand(B, L, L, ns), scal[:, None, :, :].expand(B, L, L, ns)], -1)
    sender = lig_attr[:, None, :, :].expand(B, L, L, D)
    vec = lig_pos[:, None, :, :] - lig_pos[:, :, None, :]  # pos[j] - pos[i]
    s_pair = edge_messages(eattr, sender, sh1(vec), pair_mask, w1, b1, w2, b2, irreps_in, irreps_out).sum(dim=-2)
    eattr_b = torch.cat([bond_emb, gather_nodes(scal, bond_src), gather_nodes(scal, bond_dst)], dim=-1)
    vec_b = gather_nodes(lig_pos, bond_dst) - gather_nodes(lig_pos, bond_src)
    msg_b = edge_messages(eattr_b, gather_nodes(lig_attr, bond_dst), sh1(vec_b), bond_mask, w1, b1, w2, b2,
                          irreps_in, irreps_out)
    s_bond, _ = scatter_mean_to_nodes(msg_b, bond_src, bond_mask, L)
    return s_pair + s_bond


def fused_tpconv_pb(lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask,
                    w1, b1, w2, b2, irreps_in: str, irreps_out: str, ns: int, packed=None):
    """Summed ligand <- ligand messages [B, L, Dout].

    lig_attr [B, L, Dl], lig_pos [B, L, 3], pair_emb [B, L, L, ns],
    pair_mask [B, L, L] bool (self-pairs excluded), bond_src/bond_dst [B, E]
    int64 (receiver/sender), bond_emb [B, E, ns], bond_mask [B, E] bool;
    w1 [3 ns, H], b1, w2 [H, W], b2 in Flax's [in, out] layout; ``packed``:
    the same weights from ``pack_weights`` (made per launch when None)."""
    if lig_attr.device.type == "cpu":
        return tpconv_pb_plain(lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask,
                               w1, b1, w2, b2, irreps_in, irreps_out, ns)
    out = _launch_pb(lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask,
                     w1, b1, w2, b2, irreps_in, irreps_out, ns, packed)
    fused_tpconv_pb.launches += 1
    return out


def _launch_pb(lig_attr, lig_pos, pair_emb, pair_mask, bond_src, bond_dst, bond_emb, bond_mask,
               w1, b1, w2, b2, irreps_in, irreps_out, ns, packed):
    dev = lig_attr.device
    lay = tp_layout(irreps_in, irreps_out)
    B, L, Dl = lig_attr.shape
    E, Fe, H = bond_src.shape[1], pair_emb.shape[-1], w2.shape[0]
    check_inputs(dev, floats=(lig_attr, lig_pos, pair_emb, bond_emb), longs=(bond_src, bond_dst),
                 bools=(pair_mask, bond_mask))
    if (Dl != lay.din or pair_emb.shape[:3] != (B, L, L) or pair_mask.shape != (B, L, L)
            or bond_dst.shape != (B, E) or bond_emb.shape != (B, E, Fe) or bond_mask.shape != (B, E)
            or tuple(w1.shape) != (Fe + 2 * ns, H) or tuple(w2.shape) != (H, lay.weight_numel)):
        raise ValueError("fused_tpconv_pb: inconsistent shapes")
    rt = pb_rows_per_block(B, L, _sm_count(dev))
    tc, _ = pick_build("fused_tpconv_pb", irreps_in, irreps_out, SH_IRREPS, Dims(Fe, ns, Fe + 2 * ns, H, Dl, lay.dout),
                       rt, True, (TM_WIDE,))
    pw = launch_weights(w1, b1, w2, b2, irreps_in, irreps_out, packed, dev)
    out = torch.empty(B, L, lay.dout, dtype=torch.float32, device=dev)
    lib = build.load("tpconv_pb")
    inputs = (ptr(lig_attr), ptr(lig_pos), ptr(pair_emb), ptr(pair_mask), ptr(bond_src), ptr(bond_dst), ptr(bond_emb),
              ptr(bond_mask))
    dims = (B, L, E, Fe, ns, H, Dl, lay.dout, rt, ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    if tc:
        tcl = tp_layout(irreps_in, irreps_out, tn=TNC)
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, tn=TNC)[:4]
        fn = lib.cbt_tpconv_pb
        fn.argtypes, fn.restype = _PB_ARGTYPES, ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2_hi), ptr(pw.w2_lo), ptr(pw.b2_tc), ptr(xtab), ptr(cg),
                  ptr(epi), ptr(epi_start), tcl.n_x, tcl.n_tiles, tcl.wpad, len(tcl.epi), len(tcl.cg), *dims)
    else:
        xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev)[:4]
        fn = lib.cbt_tpconv_pb_wide
        fn.argtypes, fn.restype = _PB_WIDE_ARGTYPES, ctypes.c_int
        code = fn(*inputs, ptr(pw.w1), ptr(pw.b1), ptr(pw.w2), ptr(pw.b2), ptr(xtab), ptr(cg), ptr(epi),
                  ptr(epi_start), lay.n_x, lay.n_tiles, lay.wpad, *dims)
    build.check(lib, code, "tpconv_pb")
    return out


fused_tpconv_pb.launches = 0


def tpconv_cross_rev_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask,
                           w1_f, b1_f, w2_f, b2_f, w1_r, b1_r, w2_r, b2_r, irreps_in, irreps_out, ns):
    """The same function in plain PyTorch (the JAX package's XLA path)."""
    B, L, K = idx.shape
    N = src_attr.shape[1]
    sender = gather_nodes(src_attr, idx)  # [B, L, K, Dr]
    vec = gather_nodes(src_pos, idx) - recv_pos[:, :, None, :]
    lscal = recv_attr[..., :ns][:, :, None, :].expand(B, L, K, ns)
    eattr = torch.cat([edge_emb, lscal, sender[..., :ns]], dim=-1)
    lig_sum = edge_messages(eattr, sender, sh1(vec), mask, w1_f, b1_f, w2_f, b2_f, irreps_in, irreps_out).sum(dim=-2)
    if w1_r is None:
        return lig_sum, None
    eattr_rl = torch.cat([edge_emb, sender[..., :ns], lscal], dim=-1)
    lig_sender = recv_attr[:, :, None, :].expand(B, L, K, recv_attr.shape[-1])
    msg = edge_messages(eattr_rl, lig_sender, sh1(-vec), mask, w1_r, b1_r, w2_r, b2_r, irreps_in, irreps_out)
    rec_sum, _ = scatter_mean_to_nodes(msg.reshape(B, L * K, -1), idx.reshape(B, -1), mask.reshape(B, -1), N)
    return lig_sum, rec_sum


def fused_tpconv_cross_rev(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask,
                           w1_f, b1_f, w2_f, b2_f, w1_r, b1_r, w2_r, b2_r, irreps_in: str, irreps_out: str, ns: int,
                           packed_f=None, packed_r=None):
    """(lig_sum [B, L, Dout], rec_sum [B, N, Dout] or None).

    recv_attr [B, L, D] ligand receivers, recv_pos [B, L, 3], src_attr
    [B, N, D] receptor table, src_pos [B, N, 3], idx [B, L, K] int64,
    edge_emb [B, L, K, ns], mask [B, L, K] bool; forward weights w*_f and
    reverse weights w*_r (None skips the reverse direction) in Flax's
    [in, out] layout; ``packed_f``/``packed_r``: the same weights from
    ``pack_weights`` (made per launch when None)."""
    if recv_attr.device.type == "cpu":
        return tpconv_cross_rev_plain(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1_f, b1_f,
                                      w2_f, b2_f, w1_r, b1_r, w2_r, b2_r, irreps_in, irreps_out, ns)
    out = _launch_cross_rev(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask, w1_f, b1_f, w2_f, b2_f,
                            w1_r, b1_r, w2_r, b2_r, irreps_in, irreps_out, ns, packed_f, packed_r)
    fused_tpconv_cross_rev.launches += 1
    return out


def _launch_cross_rev(recv_attr, recv_pos, src_attr, src_pos, idx, edge_emb, mask,
                      w1_f, b1_f, w2_f, b2_f, w1_r, b1_r, w2_r, b2_r, irreps_in, irreps_out, ns, packed_f, packed_r):
    dev = recv_attr.device
    lay = tp_layout(irreps_in, irreps_out)
    B, L, D = recv_attr.shape
    N, K, Fe, H = src_attr.shape[1], idx.shape[2], edge_emb.shape[-1], w2_f.shape[0]
    with_rev = w1_r is not None
    check_inputs(dev, floats=(recv_attr, recv_pos, src_attr, src_pos, edge_emb), longs=(idx,), bools=(mask,))
    if (D != lay.din or src_attr.shape != (B, N, D) or src_pos.shape != (B, N, 3) or idx.shape != (B, L, K)
            or edge_emb.shape[:3] != (B, L, K) or mask.shape != (B, L, K)
            or tuple(w1_f.shape) != (Fe + 2 * ns, H) or tuple(w2_f.shape) != (H, lay.weight_numel)
            or (with_rev and (w1_r.shape != w1_f.shape or w2_r.shape != w2_f.shape))):
        raise ValueError("fused_tpconv_cross_rev: inconsistent shapes")
    tc, _ = pick_build("fused_tpconv_cross_rev", irreps_in, irreps_out, SH_IRREPS,
                       Dims(Fe, ns, Fe + 2 * ns, H, D, lay.dout), RT_CROSS, True, (TM_WIDE,))
    fields = ((lambda p: (p.w1, p.b1, p.w2_hi, p.w2_lo, p.b2_tc)) if tc else (lambda p: (p.w1, p.b1, p.w2, p.b2)))
    fwd = fields(launch_weights(w1_f, b1_f, w2_f, b2_f, irreps_in, irreps_out, packed_f, dev))
    rev = (fields(launch_weights(w1_r, b1_r, w2_r, b2_r, irreps_in, irreps_out, packed_r, dev)) if with_rev
           else (None,) * len(fwd))
    out_lig = torch.empty(B, L, lay.dout, dtype=torch.float32, device=dev)
    out_rec = torch.empty(B, N, lay.dout, dtype=torch.float32, device=dev) if with_rev else None
    lib = build.load("tpconv_cross_rev")
    tl = tp_layout(irreps_in, irreps_out, tn=TNC) if tc else lay
    xtab, cg, epi, epi_start = device_tables(irreps_in, irreps_out, dev, tn=TNC if tc else TN)[:4]
    inputs = (ptr(recv_attr), ptr(recv_pos), ptr(src_attr), ptr(src_pos), ptr(idx), ptr(edge_emb), ptr(mask),
              *map(ptr, fwd), *map(ptr, rev), int(with_rev), ptr(xtab), ptr(cg), ptr(epi), ptr(epi_start),
              tl.n_x, tl.n_tiles, tl.wpad)
    dims = (B, L, N, K, Fe, ns, H, D, lay.dout, RT_CROSS, ptr(out_lig), ptr(out_rec),
            torch.cuda.current_stream(dev).cuda_stream)
    if tc:
        fn = lib.cbt_tpconv_cross_rev
        fn.argtypes, fn.restype = _CROSS_ARGTYPES, ctypes.c_int
        code = fn(*inputs, len(tl.epi), len(tl.cg), *dims)
    else:
        fn = lib.cbt_tpconv_cross_rev_wide
        fn.argtypes, fn.restype = _CROSS_WIDE_ARGTYPES, ctypes.c_int
        code = fn(*inputs, *dims)
    build.check(lib, code, "tpconv_cross_rev")
    return out_lig, out_rec


fused_tpconv_cross_rev.launches = 0
