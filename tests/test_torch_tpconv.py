"""The port's TP-conv plain versions against the JAX Pallas kernels.

Each kernel's plain PyTorch version (what the CUDA wrapper runs for CPU
tensors) gets the same numpy inputs as the Pallas function, which runs as
tests/test_pallas_tpconv.py runs it (interpret=True, use_bf16=False).
Tolerance: rtol = atol = 2e-4, the JAX package's own kernel-test bar. The
CUDA kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops.pallas import tpconv_lig as jlig
from confidence_bootstrapping_tpu.ops.pallas import tpconv_rec as jrec
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common, tpconv_lig, tpconv_rec
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

SMALL = "8x0e + 3x1o + 3x1e + 2x0o"
FLAGSHIP = "32x0e + 6x1o + 6x1e + 6x0o"
TOL = dict(rtol=2e-4, atol=2e-4)


def _ns(irreps):
    return int(irreps.split("x")[0])


def _weights(rng, F, H, W):
    return [rng.randn(F, H).astype(np.float32) * 0.2, rng.randn(H).astype(np.float32) * 0.1,
            rng.randn(H, W).astype(np.float32) * 0.2, rng.randn(W).astype(np.float32) * 0.1]


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("irreps,K,masked_tile", [(SMALL, 6, False), (FLAGSHIP, 6, False), (SMALL, 7, True)])
def test_rec_plain_matches_pallas(irreps, K, masked_tile):
    rng = np.random.RandomState(0)
    ns, B, N = _ns(irreps), 2, 16
    D = WeightedTensorProduct(irreps, "1x0e + 1x1o", irreps).irreps_in.dim
    W = WeightedTensorProduct(irreps, "1x0e + 1x1o", irreps).weight_numel
    node = rng.randn(B, N, D).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 3).astype(np.float32)
    nbr = rng.randint(0, N, (B, N, K)).astype(np.int32)
    emb = rng.randn(B, N, K, ns).astype(np.float32)
    sig = rng.randn(B, ns).astype(np.float32)
    mask = rng.rand(B, N, K) > 0.3
    if masked_tile:
        mask[:, :8] = False  # a whole receiver tile of the Pallas grid
    w = _weights(rng, 3 * ns, 3 * ns, W)
    want = jrec.fused_tpconv_rec(node, pos, nbr, emb, sig, mask, *w, irreps, irreps, ns, tile_n=8,
                                 interpret=True, use_bf16=False)
    got = tpconv_rec.fused_tpconv_rec(*map(_torch, (node, pos, nbr, emb, sig, mask, *w)), irreps, irreps, ns)
    _close(got, want)
    if masked_tile:
        assert float(got[:, :8].abs().max()) == 0.0


@pytest.mark.parametrize("irreps", [SMALL, FLAGSHIP])
def test_pb_plain_matches_pallas(irreps):
    rng = np.random.RandomState(1)
    ns, B, L, E = _ns(irreps), 2, 16, 20
    tp = WeightedTensorProduct(irreps, "1x0e + 1x1o", irreps)
    lig = rng.randn(B, L, tp.irreps_in.dim).astype(np.float32)
    pos = (rng.randn(B, L, 3) * 2).astype(np.float32)
    pair_emb = rng.randn(B, L, L, ns).astype(np.float32)
    pair_mask = (rng.rand(B, L, L) > 0.5) & ~np.eye(L, dtype=bool)[None]
    pair_mask[:, 8:] = False  # the second receiver tile has bond edges only
    src = rng.randint(0, L, (B, E)).astype(np.int32)
    dst = rng.randint(0, L, (B, E)).astype(np.int32)
    bond_emb = rng.randn(B, E, ns).astype(np.float32)
    bond_mask = rng.rand(B, E) > 0.3
    w = _weights(rng, 3 * ns, 3 * ns, tp.weight_numel)
    args = (lig, pos, pair_emb, pair_mask, src, dst, bond_emb, bond_mask, *w)
    want = jlig.fused_tpconv_pb(*args, irreps, irreps, ns, interpret=True, use_bf16=False)
    got = tpconv_lig.fused_tpconv_pb(*map(_torch, args), irreps, irreps, ns)
    _close(got, want)


@pytest.mark.parametrize("irreps,K,with_rev", [(SMALL, 16, True), (FLAGSHIP, 16, True), (SMALL, 12, False),
                                               (FLAGSHIP, 12, False), (SMALL, 12, True)])
def test_cross_rev_plain_matches_pallas(irreps, K, with_rev):
    rng = np.random.RandomState(2)
    ns, B, L, N = _ns(irreps), 2, 8, 24
    tp = WeightedTensorProduct(irreps, "1x0e + 1x1o", irreps)
    D = tp.irreps_in.dim
    lig = rng.randn(B, L, D).astype(np.float32)
    lpos = (rng.randn(B, L, 3) * 2).astype(np.float32)
    rec = rng.randn(B, N, D).astype(np.float32)
    rpos = (rng.randn(B, N, 3) * 4).astype(np.float32)
    idx = rng.randint(0, N, (B, L, K)).astype(np.int32)
    emb = rng.randn(B, L, K, ns).astype(np.float32)
    mask = rng.rand(B, L, K) > 0.3
    mask[1] = False  # a wholly masked batch element
    wf = _weights(rng, 3 * ns, 3 * ns, tp.weight_numel)
    wr = _weights(rng, 3 * ns, 3 * ns, tp.weight_numel) if with_rev else [None] * 4
    args = (lig, lpos, rec, rpos, idx, emb, mask, *wf)
    want_l, want_r = jlig.fused_tpconv_cross_rev(*args, *wr, irreps, irreps, ns, interpret=True, use_bf16=False)
    got_l, got_r = tpconv_lig.fused_tpconv_cross_rev(*map(_torch, args), *[None if a is None else _torch(a) for a in wr],
                                                     irreps, irreps, ns)
    _close(got_l, want_l)
    if with_rev:
        _close(got_r, want_r)
        assert float(got_r[1].abs().max()) == 0.0
    else:
        assert got_r is None and want_r is None


@pytest.mark.parametrize("irreps_in,irreps_out", [("16x0e", "16x0e + 4x1o"), (FLAGSHIP, FLAGSHIP),
                                                  (FLAGSHIP, "2x1o + 2x1e")])
def test_kernel_layout_covers_every_weight_once(irreps_in, irreps_out):
    """The kernels' v-major weight permutation, X table and epilogue items
    reproduce WeightedTensorProduct when evaluated in numpy (the tables hold
    float32 CG coefficients and scales, hence the float32 tolerance)."""
    lay = tpconv_common.tp_layout(irreps_in, irreps_out)
    tp = WeightedTensorProduct(irreps_in, "1x0e + 1x1o", irreps_out)
    assert sorted(lay.perm.tolist()) == list(range(tp.weight_numel))
    rng = np.random.RandomState(3)
    x = rng.randn(lay.din).astype(np.float64)
    v = rng.randn(3)
    sh = np.concatenate([[1.0], np.sqrt(3) * v / np.linalg.norm(v)])
    w = rng.randn(tp.weight_numel)
    X = np.array([sum(x[r[0] + a] * sh[r[2] + b] * lay.cg[r[6] + (a * r[3] + b) * r[4] + r[5]]
                      for a in range(r[1]) for b in range(r[3])) for r in lay.xtab])
    wk = np.zeros(lay.wpad)
    wk[: tp.weight_numel] = w[lay.perm] * lay.scale
    out = np.zeros(lay.dout)
    for t in range(lay.n_tiles):
        for lo, hi, xb, step, oc in lay.epi[lay.epi_start[t]: lay.epi_start[t + 1]]:
            out[oc] += sum(wk[t * tpconv_common.TN + n] * X[xb + (n - lo) * step] for n in range(lo, hi))
    want = tp(torch.as_tensor(x), torch.as_tensor(sh), torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


def test_pack_weights_permutes_scales_and_pads_w2():
    """The kernel-layout weights: w2 and b2 columns in the layout's order,
    scaled by 1/sqrt(fan) and zero-padded to whole column tiles; w1 and b1
    as given. TPConv makes them only for CUDA tensors."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    lay = tpconv_common.tp_layout(FLAGSHIP, FLAGSHIP)
    rng = np.random.RandomState(4)
    w1, b1, w2, b2 = map(torch.as_tensor, _weights(rng, 96, 96, lay.weight_numel))
    packed = tpconv_common.pack_weights(w1.t().contiguous().t(), b1, w2, b2, FLAGSHIP, FLAGSHIP)
    assert packed.w1.is_contiguous() and torch.equal(packed.w1, w1) and torch.equal(packed.b1, b1)
    perm, scale = torch.as_tensor(lay.perm), torch.as_tensor(lay.scale)
    assert tuple(packed.w2.shape) == (96, lay.wpad) and tuple(packed.b2.shape) == (lay.wpad,)
    torch.testing.assert_close(packed.w2[:, : lay.weight_numel], w2[:, perm] * scale, rtol=0, atol=0)
    torch.testing.assert_close(packed.b2[: lay.weight_numel], b2[perm] * scale, rtol=0, atol=0)
    assert not packed.w2[:, lay.weight_numel:].any() and not packed.b2[lay.weight_numel:].any()
    conv = TPConv(FLAGSHIP, "1x0e + 1x1o", FLAGSHIP, 96)
    assert conv.packed_weights(0, torch.zeros(1, lay.din)) is None
