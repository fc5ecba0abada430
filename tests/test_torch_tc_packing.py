"""The host half of the tensor-core stage (rec and cross_rev kernels), on the CPU.

``pack_weights`` splits w2 into TF32 parts and cuts them into the tiles the
kernels' bulk copies and ``wgmma`` read (``ops/cuda/tpconv_common.py``);
the kernels' side runs on the card (``tests/test_torch_kernels_cuda.py``).
Here: the split's bits, the tile layout against the packed [H, Wpad]
matrix, and a plain emulation of the 3xTF32 product at the score model's
full width, which meets the kernels' 2e-4 x max(1, max |plain|) bar where a
single TF32 product does not.
"""

import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common as tc
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

FLAGSHIP = "32x0e + 6x1o + 6x1e + 32x0o"  # the score model's 100 -> 100 layer (W=2960)
REL = 2e-4


def untile_w2(tiles, H):
    """The inverse of ``tile_w2``: [H, Wpad]."""
    n_tiles, g8, q4 = tiles.shape[:3]
    return tiles.permute(0, 1, 3, 2, 4).reshape(n_tiles * g8 * 8, q4 * 4).t()[:H].contiguous()


def _mlp(irreps_in, irreps_out, H, seed):
    """Edge-MLP weights at the card tests' scale (0.2 N(0, 1))."""
    g = torch.Generator().manual_seed(seed)
    W = WeightedTensorProduct(irreps_in, tc.SH_IRREPS, irreps_out).weight_numel
    return [torch.randn(s, generator=g) * 0.2 for s in ((96, H), (H,), (H, W), (W,))]


@pytest.mark.parametrize("irreps_in,irreps_out,H", [
    (FLAGSHIP, FLAGSHIP, 96),
    ("10x0e + 2x1o", "10x0e + 2x1o + 2x1e", 30),  # H not a multiple of 8
])
def test_pack_weights_splits_w2_into_tf32_parts(irreps_in, irreps_out, H):
    p = tc.pack_weights(*_mlp(irreps_in, irreps_out, H, 0), irreps_in, irreps_out)
    hp = -(-H // 8) * 8
    lay = tc.tp_layout(irreps_in, irreps_out, tn=tc.TNC)
    assert p.w2_hi.shape == p.w2_lo.shape == (lay.n_tiles, tc.TNC // 8, hp // 4, 8, 4)
    assert p.b2_tc.shape == (lay.wpad,)
    for part in (p.w2_hi, p.w2_lo):  # TF32: the low 13 mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    w2 = untile_w2(p.w2_hi, H).double() + untile_w2(p.w2_lo, H).double()
    want = torch.zeros(H, lay.wpad, dtype=torch.float64)
    want[:, : lay.weight_numel] = p.w2[:, : lay.weight_numel].double()
    err = (w2 - want).abs()
    assert float((err - 2.0 ** -22 * want.abs()).max()) <= 0.0  # hi + lo is w2 to float32 rounding
    hi = untile_w2(p.w2_hi, H).double()  # hi is a nearest TF32 value
    assert float(((hi - want).abs() - 2.0 ** -11 * want.abs()).max()) <= 0.0
    assert torch.equal(p.b2_tc[: lay.weight_numel], p.b2[: lay.weight_numel])
    assert float(p.b2_tc[lay.weight_numel:].abs().sum()) == 0.0


@pytest.mark.parametrize("H,wpad", [(96, 2976), (30, 96)])
def test_tile_layout_maps_back_to_the_packed_matrix(H, wpad):
    w = torch.randn(H, wpad, generator=torch.Generator().manual_seed(1))
    tiles = tc.tile_w2(w)
    assert torch.equal(untile_w2(tiles, H), w)
    hp = tiles.shape[2] * 4
    flat = tiles.reshape(-1)
    rng = np.random.RandomState(2)
    for k, n in zip(rng.randint(0, hp, 200), rng.randint(0, wpad, 200)):
        t, j, r, q, e = n // tc.TNC, (n % tc.TNC) // 8, n % 8, k // 4, k % 4
        # tile t, core matrix (8-column group j, 4-k chunk q), row r, element e
        off = (((t * (tc.TNC // 8) + j) * (hp // 4) + q) * 8 + r) * 4 + e
        assert float(flat[off]) == (float(w[k, n]) if k < H else 0.0)


def test_3xtf32_product_meets_the_kernel_tolerance_where_one_tf32_product_does_not():
    H = 96
    w1, b1, w2, b2 = _mlp(FLAGSHIP, FLAGSHIP, H, 3)
    p = tc.pack_weights(w1, b1, w2, b2, FLAGSHIP, FLAGSHIP)
    h = torch.relu(torch.randn(64, H, generator=torch.Generator().manual_seed(4)))  # one chunk's hidden layer
    w_hi, w_lo = untile_w2(p.w2_hi, H), untile_w2(p.w2_lo, H)
    h_hi, h_lo = tc.split_tf32(h)
    W = tc.tp_layout(FLAGSHIP, FLAGSHIP).weight_numel
    plain = h @ p.w2[:, :W]  # the float32 product
    three = (h_lo @ w_hi + h_hi @ w_lo + h_hi @ w_hi)[:, :W]
    one = (h_hi @ w_hi)[:, :W]
    scale = max(1.0, float(plain.abs().max()))
    err3, err1 = float((three - plain).abs().max()), float((one - plain).abs().max())
    assert err3 <= REL * scale / 20, (err3, scale)
    assert err1 > REL * scale, (err1, scale)
