"""Hidden widths above 96 and ladders wider than the score model's ns=32/nv=6,
on the CPU.

The kernels' shared-memory layouts are mirrored on the host
(``tpconv_common.engine_smem_bytes``, ``tpconv_bwd.bwd_smem_bytes``; the
card tests hold the mirror against each kernel library) and the wrappers pick
a build by them (``pick_build``, ``bwd_build``). Here: every engine instance
on the score model's paths at ns=32/nv=6 keeps the build and bytes it had;
every layer of the ns=48/nv=10 ladder (DiffDock's published score-model
width, H=144) routes to a build that fits, with and without the
pseudoscalars reduced to nv (``ScoreModelConfig``'s default reduces them);
the confidence trunk's rec_g layers fit the tensor-core stage; a layer no
build fits raises, naming the bytes. The plain rec, pb and cross_rev agree with the Pallas kernels
(interpret mode, ``use_bf16=False``, the JAX package's 2e-4) at an ns=48
layer pair, and ``TPConv`` at ns=48 reaches the same wrappers as at ns=32.
"""

import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops.pallas import tpconv_lig as jlig
from confidence_bootstrapping_tpu.ops.pallas import tpconv_rec as jrec
from confidence_bootstrapping_tpu_torch.models import layers
from confidence_bootstrapping_tpu_torch.models.score_model import get_irrep_seq
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_common as tc, tpconv_lig, tpconv_rec
from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_g import RT_REC, cross_rows_per_block
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

SH1, SH2, TOR = tc.SH_IRREPS, tc.SH2_IRREPS, tc.TOR_SH_IRREPS
TOL = dict(rtol=2e-4, atol=2e-4)


def ladder(ns, nv):
    """The score model's (irreps_in, irreps_out) pairs: the embedding steps,
    then the trunk's last irreps to itself."""
    seq = get_irrep_seq(ns, nv, False)
    return [(seq[min(i, 3)], seq[min(i + 1, 3)]) for i in range(4)]


def dims(ir_in, ir_out, ns, sh=SH1):
    """The gather kernels' Dims: Fe = ns, F = 3 ns, H = 3 ns (score_model.py)."""
    lay = tc.tp_layout(ir_in, ir_out, sh)
    return tc.Dims(ns, ns, 3 * ns, 3 * ns, lay.din, lay.dout)


def tc_bytes(ir_in, ir_out, sh, d, rt):
    lay = tc.tp_layout(ir_in, ir_out, sh, tc.TNC)
    return tc.engine_smem_bytes(tc.sh_dim(sh), tc.TM, d, lay.n_x, rt, True, len(lay.cg), len(lay.epi), lay.n_tiles)


def test_score_model_ladder_keeps_its_builds_and_bytes():
    """ns=32/nv=6: rec, pb and cross_rev on the tensor-core stage with the
    bytes the kernels took before (rec: 139,248 to 206,448), every float32
    instance (rec with the dropout mask, the edge-list kernel with both
    harmonics, row 4) at 64 edges a chunk, the backward at 32 edges a block;
    each within the 232,448 bytes a block may take."""
    want_rec = [139_248, 152_160, 172_928, 206_448]
    pb_rt = tpconv_lig.pb_rows_per_block(32, 24, 132)
    for (a, b), rec_bytes in zip(ladder(32, 6), want_rec):
        d = dims(a, b, 32)
        assert tc_bytes(a, b, SH1, d, tpconv_rec.RT) == rec_bytes
        for what, rt in (("rec", tpconv_rec.RT), ("pb", pb_rt), ("cross_rev", tpconv_lig.RT_CROSS)):
            assert tc.pick_build(what, a, b, SH1, d, rt, True, (tc.TM_WIDE,)) == (True, tc.TM)
            assert tc_bytes(a, b, SH1, d, rt) + tc.engine_static_bytes(tc.TM, True) <= tc.SMEM_LIMIT
        edge = tc.Dims(96, 0, 96, 96, d.Din, d.Dout)
        assert tc.pick_build("rec_dm", a, b, SH1, d, tpconv_rec.RT, False) == (False, tc.TM)
        assert tc.pick_build("cross", a, b, SH1, d, cross_rows_per_block(100), False) == (False, tc.TM)
        assert tc.pick_build("edge", a, b, SH1, edge, cross_rows_per_block(24), False) == (False, tc.TM)
        lay = tc.tp_layout(a, b)
        assert tpconv_bwd.bwd_build(96, 96, lay.din, 4, lay.dout, lay.n_x) == 32
    final = "32x0e + 6x1o + 6x1e + 32x0o"
    for out, sh, F in (("32x0o + 32x0e", TOR, 96), ("2x1o + 2x1e", SH1, 64)):  # torsion head, center conv
        lay = tc.tp_layout(final, out, sh)
        d = tc.Dims(F, 0, F, F, lay.din, lay.dout)
        assert tc.pick_build("edge", final, out, sh, d, cross_rows_per_block(24), False) == (False, tc.TM)
        assert tpconv_bwd.bwd_build(F, F, lay.din, tc.sh_dim(sh), lay.dout, lay.n_x) == 32


def test_wide_ladder_routes_every_layer_to_a_build_that_fits():
    """ns=48/nv=10 (H=144): the inference kernels on the float32 builds at 32
    edges a chunk (156,544 bytes at 156 -> 156 for rec, against 310,288 on
    the tensor-core stage and 295,040 at 64 edges); the training kernels at
    64 edges where that fits and 32 where not; the backward at 16 edges a
    block (248,320 bytes at 32)."""
    layers_ = ladder(48, 10)
    for i, (a, b) in enumerate(layers_):
        d = dims(a, b, 48)
        for what, rt in (("rec", tpconv_rec.RT), ("pb", tpconv_lig.pb_rows_per_block(32, 24, 132)),
                         ("cross_rev", tpconv_lig.RT_CROSS)):
            build = tc.pick_build(what, a, b, SH1, d, rt, True, (tc.TM_WIDE,))
            assert build == (False, tc.TM_WIDE)
            S = tc.tp_layout(a, b).n_x
            assert tc.engine_smem_bytes(4, tc.TM_WIDE, d, S, rt) + tc.engine_static_bytes(32, False) <= tc.SMEM_LIMIT
        # 64 edges a chunk fits rec's first two layers and row 4's first three (one receiver a block, 232,312 bytes
        # at 108 -> 156 with the static 3,080)
        assert tc.pick_build("rec_dm", a, b, SH1, d, tpconv_rec.RT, False) == (False, tc.TM if i < 2 else tc.TM_WIDE)
        assert tc.pick_build("cross", a, b, SH1, d, cross_rows_per_block(100), False) == (False, tc.TM if i < 3
                                                                                            else tc.TM_WIDE)
        lay = tc.tp_layout(a, b)
        assert tpconv_bwd.bwd_build(144, 144, lay.din, 4, lay.dout, lay.n_x) == 16
    d = dims(*layers_[3], 48)
    S = tc.tp_layout(*layers_[3]).n_x
    assert tc.engine_smem_bytes(4, tc.TM_WIDE, d, S, 8) == 156_544
    assert tc.engine_smem_bytes(4, tc.TM, d, S, 8) == 295_040
    assert tc_bytes(*layers_[3], SH1, d, 8) == 310_288
    assert tpconv_bwd.bwd_smem_bytes(32, 144, 144, 156, 4, 156, 524) == 248_320


@pytest.mark.parametrize("ns,nv,inference", [(32, 6, (True, tc.TM)), (48, 10, (False, tc.TM_WIDE))])
def test_default_config_ladder_routes_every_layer_to_a_build_that_fits(ns, nv, inference):
    """The ladder ScoreModelConfig runs by default (pseudoscalars reduced to
    nv: 74 -> 74 at ns=32, 118 -> 118 at ns=48): rec, pb and cross_rev on
    the tensor-core stage at ns=32 and the 32-edge float32 builds at ns=48;
    every training and composed-route instance and the backward take a build
    within the 232,448 bytes a block may take."""
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig

    assert ScoreModelConfig().reduce_pseudoscalars
    seq = get_irrep_seq(ns, nv, True)
    for a, b in [(seq[min(i, 3)], seq[min(i + 1, 3)]) for i in range(4)]:
        d = dims(a, b, ns)
        for what, rt in (("rec", tpconv_rec.RT), ("pb", tpconv_lig.pb_rows_per_block(32, 24, 132)),
                         ("cross_rev", tpconv_lig.RT_CROSS)):
            assert tc.pick_build(what, a, b, SH1, d, rt, True, (tc.TM_WIDE,)) == inference
        edge = tc.Dims(3 * ns, 0, 3 * ns, 3 * ns, d.Din, d.Dout)
        for what, dd, rt in (("rec_dm", d, tpconv_rec.RT), ("cross", d, cross_rows_per_block(100)),
                             ("edge", edge, cross_rows_per_block(24))):
            on_tc, cm = tc.pick_build(what, a, b, SH1, dd, rt, False)
            S = tc.tp_layout(a, b).n_x
            assert not on_tc and tc.engine_smem_bytes(4, cm, dd, S, rt) + tc.engine_static_bytes(cm, False) <= \
                tc.SMEM_LIMIT
        lay = tc.tp_layout(a, b)
        assert tpconv_bwd.bwd_build(3 * ns, 3 * ns, lay.din, 4, lay.dout, lay.n_x) in (32, 16)


def test_confidence_trunk_fits_the_tensor_core_stage():
    """rec_g (lmax=2, ns=24: H=72) at every layer of the confidence trunk:
    175,296 bytes at 84 -> 84."""
    for a, b in ladder(24, 6):
        d = dims(a, b, 24, SH2)
        assert tc.pick_build("rec_g", a, b, SH2, d, RT_REC, True, (tc.TM_WIDE,)) == (True, tc.TM)
    a, b = ladder(24, 6)[3]
    assert tc_bytes(a, b, SH2, dims(a, b, 24, SH2), RT_REC) == 175_296


def test_a_layer_no_build_fits_raises_naming_the_bytes():
    wide = "128x0e + 40x1o + 40x1e + 128x0o"
    d = dims(wide, wide, 128)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tc.pick_build("fused_tpconv_rec", wide, wide, SH1, d, 8, True, (tc.TM_WIDE,))
    lay = tc.tp_layout(wide, wide)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tpconv_bwd.bwd_build(384, 384, lay.din, 4, lay.dout, lay.n_x)


def test_pb_rows_per_block_fills_one_wave():
    assert tpconv_lig.pb_rows_per_block(32, 24, 132) == 6  # 128 blocks
    assert tpconv_lig.pb_rows_per_block(8, 24, 132) == 2
    assert tpconv_lig.pb_rows_per_block(64, 24, 132) == 12  # 128 blocks
    assert tpconv_lig.pb_rows_per_block(200, 24, 132) == 24  # more poses than SMs: a pose a block


def _weights(rng, F, H, W):
    return [rng.randn(F, H).astype(np.float32) * 0.2, rng.randn(H).astype(np.float32) * 0.1,
            rng.randn(H, W).astype(np.float32) * 0.2, rng.randn(W).astype(np.float32) * 0.1]


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def test_plain_versions_match_pallas_at_the_wide_ladder():
    """rec, pb and cross_rev (with reverse weights) at the ns=48 ladder's
    48x0e + 10x1o -> 48x0e + 10x1o + 10x1e step, H=144."""
    ir_in, ir_out = ladder(48, 10)[1]
    ns, B, N, L, K, E = 48, 1, 16, 8, 16, 10
    tp = WeightedTensorProduct(ir_in, SH1, ir_out)
    D, W = tp.irreps_in.dim, tp.weight_numel
    rng = np.random.RandomState(5)
    node = rng.randn(B, N, D).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 3).astype(np.float32)
    nbr = rng.randint(0, N, (B, N, 6)).astype(np.int32)
    emb = rng.randn(B, N, 6, ns).astype(np.float32)
    sig = rng.randn(B, ns).astype(np.float32)
    mask = rng.rand(B, N, 6) > 0.3
    w = _weights(rng, 3 * ns, 3 * ns, W)
    want = jrec.fused_tpconv_rec(node, pos, nbr, emb, sig, mask, *w, ir_in, ir_out, ns, tile_n=8, interpret=True,
                                 use_bf16=False)
    got = tpconv_rec.fused_tpconv_rec(*map(_torch, (node, pos, nbr, emb, sig, mask, *w)), ir_in, ir_out, ns)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    lig = rng.randn(B, L, D).astype(np.float32)
    lpos = (rng.randn(B, L, 3) * 2).astype(np.float32)
    pair_emb = rng.randn(B, L, L, ns).astype(np.float32)
    pair_mask = (rng.rand(B, L, L) > 0.5) & ~np.eye(L, dtype=bool)[None]
    src, dst = rng.randint(0, L, (B, E)).astype(np.int32), rng.randint(0, L, (B, E)).astype(np.int32)
    bond_emb = rng.randn(B, E, ns).astype(np.float32)
    bond_mask = rng.rand(B, E) > 0.3
    args = (lig, lpos, pair_emb, pair_mask, src, dst, bond_emb, bond_mask, *w)
    want = jlig.fused_tpconv_pb(*args, ir_in, ir_out, ns, interpret=True, use_bf16=False)
    got = tpconv_lig.fused_tpconv_pb(*map(_torch, args), ir_in, ir_out, ns)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # cross_rev reads both node tables at the input width and writes the output width to both
    idx = rng.randint(0, N, (B, L, K)).astype(np.int32)
    cemb = rng.randn(B, L, K, ns).astype(np.float32)
    cmask = rng.rand(B, L, K) > 0.3
    wr = _weights(rng, 3 * ns, 3 * ns, W)
    args = (lig, lpos, node, pos, idx, cemb, cmask, *w)
    want_l, want_r = jlig.fused_tpconv_cross_rev(*args, *wr, ir_in, ir_out, ns, interpret=True, use_bf16=False)
    got_l, got_r = tpconv_lig.fused_tpconv_cross_rev(*map(_torch, args), *map(_torch, wr), ir_in, ir_out, ns)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)


@pytest.mark.parametrize("ns,nv", [(32, 6), (48, 10)])
def test_tpconv_reaches_the_same_wrappers_at_either_width(ns, nv, monkeypatch):
    """conv_rec, conv_pb and conv_cross_rev of a trunk-layer TPConv call
    fused_tpconv_rec, fused_tpconv_pb and fused_tpconv_cross_rev at ns=48 as
    at ns=32 (the wrappers pick the build; TPConv does not look at H)."""
    irreps = ladder(ns, nv)[3][0]
    conv = layers.TPConv(irreps, SH1, irreps, 3 * ns, num_groups=2, hidden_features=3 * ns)
    called = []
    for name in ("fused_tpconv_rec", "fused_tpconv_pb", "fused_tpconv_cross_rev"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **k: called.append(_n) or _f(*a, **k))
    g = torch.Generator().manual_seed(0)
    B, N, L, K, D = 1, 32, 8, 16, conv.tp.irreps_in.dim
    node, pos = torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 3
    nbr, emb = torch.randint(0, N, (B, N, 4), generator=g), torch.randn(B, N, 4, ns, generator=g)
    with torch.no_grad():
        conv.conv_rec(0, node, pos, nbr, emb, torch.zeros(B, ns), torch.ones(B, N, 4, dtype=torch.bool))
        lig, lpos = torch.randn(B, L, D, generator=g), torch.randn(B, L, 3, generator=g)
        pm = ~torch.eye(L, dtype=torch.bool)[None]
        src = torch.randint(0, L, (B, 4), generator=g)
        out = conv.conv_pb(0, lig, lpos, torch.randn(B, L, L, ns, generator=g), pm, src, src.flip(-1),
                           torch.randn(B, 4, ns, generator=g), torch.ones(B, 4, dtype=torch.bool), ns)
        idx = torch.randint(0, N, (B, L, K), generator=g)
        rev = conv.conv_cross_rev(0, 1, lig, lpos, node, pos, idx, torch.randn(B, L, K, ns, generator=g),
                                  torch.ones(B, L, K, dtype=torch.bool), ns)
    assert out is not None and rev is not None
    assert called == ["fused_tpconv_rec", "fused_tpconv_pb", "fused_tpconv_cross_rev"]
    assert conv.edge_mlps[0].layers[0].weight.shape[0] == 3 * ns  # H = 3 ns: 144 at ns=48, above KMAX
