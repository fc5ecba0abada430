"""The v1 API of the fused edge-list TP-conv.

Replaces ``confidence_bootstrapping_tpu/ops/pallas/tpconv.py:
fused_tpconv_nbr`` and ``fused_tpconv_msgs``, the TPU's first, striped
kernels. They compute the same functions as the v3 kernels (only tests call
them in the JAX package), so here they are thin wrappers over
``tpconv_v3``, with the v1 signatures: no kernel of their own, and their
launches count as the v3 wrappers'.
"""

from __future__ import annotations

from typing import Optional

from . import tpconv_v3


def fused_tpconv_nbr(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str,
                     tile_m: Optional[int] = None, interpret: bool = False, use_bf16: bool = True,
                     debug_stage: int = 0):
    """Message sums [M, Dout] over neighbour lists: edge_attr [M, K, Fe],
    sender [M, K, Din] (canonical irreps layout), sh [M, K, 4], mask [M, K]
    bool, w1 [Fe, H], b1, w2 [H, numel], b2. The Pallas tiling and debug
    arguments are ignored."""
    return tpconv_v3.fused_tpconv_nbr(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out)


def fused_tpconv_msgs(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in: str, irreps_out: str,
                      tile_m: Optional[int] = None, interpret: bool = False, use_bf16: bool = True):
    """Per-edge messages [M, K, Dout], masked edges exactly zero; arguments
    as ``fused_tpconv_nbr``."""
    return tpconv_v3.fused_tpconv_msgs(edge_attr, sender, sh, mask, w1, b1, w2, b2, irreps_in, irreps_out)
