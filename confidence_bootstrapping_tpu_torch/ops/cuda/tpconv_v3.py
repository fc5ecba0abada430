"""Edge-list TP-conv at inference with lmax=1 harmonics (kernel
``csrc/tpconv_edge.cu``).

Replaces ``confidence_bootstrapping_tpu/ops/pallas/tpconv_v3.py``:

* ``fused_tpconv_nbr``: message sums [M, Dout] over pre-gathered edge lists
  [M, K, *] (the edge MLP, the weighted TP and the mask, then the sum over
  K);
* ``fused_tpconv_msgs``: each edge's message [M, K, Dout], exactly zero on a
  masked edge.

The v3 Pallas kernels are the TPU's build of ``tpconv_g._call_g`` for the
score model's irreps ladder at 4 harmonic components (the JAX tests pin the
two equal), so both wrappers launch the edge-list kernel's inference
instance that the training forward already uses (``tpconv_edge_tc_kernel<4,
false>`` where the layer fits the tensor-core stage, otherwise a float32
build). Each counts its own launches (``fused_tpconv_nbr.launches``,
``fused_tpconv_msgs.launches``), apart from ``fused_tpconv_edge.launches``.
The score model reaches them when its ladder-path gates fail: the ligand
pairs when L % 8 != 0, the receptor kNN groups when N % 32 != 0 (``nbr``),
the receptor <- ligand cross lists when K % 16 != 0 (``msgs``). For CPU
tensors the plain versions run; for CUDA tensors the kernel runs or the
wrapper raises.
"""

from __future__ import annotations

from .tpconv_common import SH_IRREPS, edge_messages
from .tpconv_edge import launch_edges


def tpconv_msgs_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out):
    """Per-edge messages [M, K, Dout] in plain PyTorch (the JAX package's XLA
    path); masked edges are zero."""
    return edge_messages(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out)


def tpconv_nbr_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out):
    """Message sums [M, Dout] in plain PyTorch."""
    return tpconv_msgs_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out).sum(dim=-2)


def fused_tpconv_nbr(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str,
                     tile_m=None, interpret: bool = False, use_bf16: bool = True, packed=None):
    """Message sums [M, Dout].

    edge_attr [M, K, F] (the whole MLP input), sender [M, K, Din], sh
    [M, K, 4] (lmax=1), mask [M, K] bool; w1 [F, H], b1, w2 [H, W], b2 in
    Flax's [in, out] layout; ``packed``: the same weights from
    ``pack_weights``. ``tile_m``, ``interpret`` and ``use_bf16`` (the
    Pallas kernel's tiling and precision) are accepted and ignored."""
    if edge_attr.device.type == "cpu":
        return tpconv_nbr_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out)
    out = launch_edges(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, SH_IRREPS, irreps_out, None, True,
                       packed)
    fused_tpconv_nbr.launches += 1
    return out


def fused_tpconv_msgs(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str,
                      tile_m=None, interpret: bool = False, use_bf16: bool = True, packed=None):
    """Per-edge messages [M, K, Dout]; a masked edge's row is exactly zero
    (the output starts zeroed and the kernel writes only valid edges).
    Arguments as ``fused_tpconv_nbr``."""
    if edge_attr.device.type == "cpu":
        return tpconv_msgs_plain(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out)
    out = launch_edges(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, SH_IRREPS, irreps_out, None, False,
                       packed)
    fused_tpconv_msgs.launches += 1
    return out


fused_tpconv_nbr.launches = 0
fused_tpconv_msgs.launches = 0
