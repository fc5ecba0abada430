"""The tensor-core builds of the edge-list kernel and of rec with the dropout
mask, on the CPU.

The edge-list kernel (``csrc/tpconv_edge.cu``: rows 5-7, and row 13 through
them) and rec's training variant (``tpconv_rec_dm_tc_kernel``) run the
engine's 3xTF32 stage at every layer of the score model's ns=32 ladder. The
kernels run only on the card (``tests/test_torch_kernels_cuda.py``); here the
stage's arithmetic is emulated (``test_torch_tc_packing.emulate_tc_messages``:
the CG contributions term by term in the kernels' order, the 3xTF32 product
from the packed tiles, the itemised epilogue of TNC-column tiles) after a
float32 hidden layer with the dropout mask applied after the ReLU, and held
against the JAX package's Pallas kernels run as its own tests run them
(``interpret=True, use_bf16=False``), at the JAX package's 2e-4: the edge
lists (``tpconv_g._call_g``: ligand pairs summed, receptor <- ligand messages
at K=100 with masked slots, the dropout mask at one value per hidden unit
and per edge, the torsion head's 20-wide harmonics) and rec with the mask
(``tpconv_g.fused_tpconv_rec_g`` at lmax=1). Then the build each wrapper
picks at every edge-list and rec-with-mask layer of both ladders, and that
the library has every build the host can pick.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops.pallas import tpconv_g as jtpg
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
from confidence_bootstrapping_tpu_torch.models.score_model import get_irrep_seq
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common as tc, tpconv_edge, tpconv_rec
from confidence_bootstrapping_tpu_torch.ops.graph_builders import gather_nodes
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct
from test_torch_tc_packing import emulate_tc_messages

SH1, SH2, TOR = tc.SH_IRREPS, tc.SH2_IRREPS, tc.TOR_SH_IRREPS
SMALL = "8x0e + 3x1o + 3x1e + 2x0o"
TOL = dict(rtol=2e-4, atol=2e-4)


def _weights(rng, F, H, W):
    return [rng.randn(F, H).astype(np.float32) * 0.3, rng.randn(H).astype(np.float32) * 0.1,
            rng.randn(H, W).astype(np.float32) * 0.3, rng.randn(W).astype(np.float32) * 0.1]


def emulate_edges(attr, x, sh, mask, dmask, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out, sum_k):
    """The tensor-core stage on edge lists [M, K, *]: the hidden layer in
    float32 (times the dropout mask after the ReLU), the stage's messages,
    masked edges zero, then the sums over K in slot order (sum_k)."""
    M, K = mask.shape
    p = tc.pack_weights(w1, b1, w2, b2, irreps_in, irreps_out, irreps_sh)
    h = torch.relu(attr.reshape(M * K, -1) @ w1 + b1)
    if dmask is not None:
        h = h * dmask.reshape(M * K, -1)
    msg = emulate_tc_messages(x.reshape(M * K, -1), sh.reshape(M * K, -1), h, p, irreps_in, irreps_out, irreps_sh)
    msg = torch.where(mask.reshape(M * K, 1), msg, torch.zeros_like(msg)).reshape(M, K, -1)
    if not sum_k:
        return msg
    out = msg[:, 0]
    for k in range(1, K):
        out = out + msg[:, k]
    return out


def _sh(rng, irreps_sh, M, K):
    vec = torch.as_tensor(rng.randn(M, K, 3).astype(np.float32))
    if irreps_sh != TOR:
        return tc.sh_kernel(vec, irreps_sh)
    # the torsion head's: sh1 (x) Y2 of a bond axis, as the score model builds them
    from confidence_bootstrapping_tpu_torch.ops.irreps import FullTensorProduct, spherical_harmonics

    axis = spherical_harmonics(2, torch.as_tensor(rng.randn(M, 1, 3).astype(np.float32)))[..., 4:]
    return FullTensorProduct(SH1, "1x2e")(tc.sh1(vec), axis.expand(M, K, 5)).float()


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out,M,K,sum_k,hd", [
    ("8x0e", SH1, "8x0e + 3x1o", 6, 7, True, None),  # ligand pairs (the first embedding step), sums
    (SMALL, SH1, SMALL, 3, 100, False, None),  # receptor <- ligand messages at the pinned cap
    (SMALL, SH1, SMALL, 5, 12, True, "H"),  # training: one dropout value per hidden unit
    (SMALL, SH1, SMALL, 5, 12, False, 1),  # and one per edge
    (SMALL, TOR, "8x0o + 8x0e", 4, 6, False, "H"),  # the torsion convolution (SHD=20, l = 3 harmonic block)
])
def test_tc_stage_matches_pallas_at_edge_list_layers(irreps_in, irreps_sh, irreps_out, M, K, sum_k, hd):
    rng = np.random.RandomState(21)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    F, H = 20, 24
    attr = torch.as_tensor(rng.randn(M, K, F).astype(np.float32))
    x = torch.as_tensor(rng.randn(M, K, tp.irreps_in.dim).astype(np.float32))
    sh = _sh(rng, irreps_sh, M, K)
    mask = torch.as_tensor(rng.rand(M, K) > 0.3)
    mask[0] = False  # a row with no valid edge
    w = [torch.as_tensor(a) for a in _weights(rng, F, H, tp.weight_numel)]
    dmask = None
    if hd is not None:
        width = H if hd == "H" else 1
        dmask = torch.as_tensor((rng.rand(M, K, width) > 0.25).astype(np.float32) / 0.75)
    got = emulate_edges(attr, x, sh, mask, dmask, *w, irreps_in, irreps_sh, irreps_out, sum_k)
    want = jtpg._call_g(*(jnp.asarray(t.numpy()) for t in (attr, x, sh, mask, *w)), irreps_in, irreps_sh, irreps_out,
                        None, True, sum_k, use_bf16=False, dmask=None if dmask is None else jnp.asarray(dmask.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0].abs().max()) == 0.0
    if not sum_k:
        assert float(got[~mask].abs().max()) == 0.0


@pytest.mark.parametrize("hd", ["H", 1])
def test_tc_stage_matches_pallas_at_rec_with_dropout_mask(hd):
    """rec's training variant: gather, lmax=1 harmonics, [emb + sig | recv
    scalars | send scalars], then the stage as above, summed over K in slot
    order; against the JAX package's rec_g kernel with the same mask."""
    rng = np.random.RandomState(22)
    ns, B, N, K, H = 8, 2, 16, 5, 24
    tp = WeightedTensorProduct(SMALL, SH1, SMALL)
    node = rng.randn(B, N, tp.irreps_in.dim).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 4).astype(np.float32)
    nbr = ((np.arange(N)[None, :, None] + rng.randint(1, N, (B, N, K))) % N).astype(np.int32)
    emb = rng.randn(B, N, K, ns).astype(np.float32)
    sig = (rng.randn(B, ns) * 0.3).astype(np.float32)
    mask = rng.rand(B, N, K) > 0.3
    mask[1, 8:16] = False  # receivers with no valid edge
    w = _weights(rng, 3 * ns, H, tp.weight_numel)
    dmask = (rng.rand(B, N, K, H if hd == "H" else 1) > 0.25).astype(np.float32) / 0.75

    t = lambda a: torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)
    tnode, tpos, tnbr = t(node), t(pos), t(nbr)
    sender = gather_nodes(tnode, tnbr)
    vec = gather_nodes(tpos, tnbr) - tpos[:, :, None, :]
    eattr = torch.cat([t(emb) + t(sig)[:, None, None, :], tnode[:, :, None, :ns].expand(B, N, K, ns), sender[..., :ns]],
                      dim=-1)
    flat = lambda a: a.reshape((B * N, K) + a.shape[3:])
    got = emulate_edges(flat(eattr), flat(sender), flat(tc.sh1(vec)), flat(t(mask)), flat(t(dmask)),
                        *map(t, w), SMALL, SH1, SMALL, True).reshape(B, N, -1)
    want = jtpg.fused_tpconv_rec_g(node, pos, nbr, emb, sig, mask, *w, SMALL, SH1, SMALL, ns, tile_n=8,
                                   interpret=True, use_bf16=False, dmask=jnp.asarray(dmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[1, 8:16].abs().max()) == 0.0


def _edge_layers(ns, nv):
    """Every edge-list layer of a training step (irreps_in, irreps_sh,
    irreps_out, F, H): the ladder's steps and its trunk (pairs, bonds and the
    cross lists, F = H = 3 ns), the center convolution (F = H = 2 ns) and the
    torsion convolution (the torsion head's harmonics)."""
    seq = get_irrep_seq(ns, nv, ScoreModelConfig().reduce_pseudoscalars)
    out = [(seq[min(i, 3)], SH1, seq[min(i + 1, 3)], 3 * ns, 3 * ns) for i in range(4)]
    out.append((seq[3], SH1, "2x1o + 2x1e", 2 * ns, 2 * ns))
    out.append((seq[3], TOR, f"{ns}x0o + {ns}x0e", 3 * ns, 3 * ns))
    return out


@pytest.mark.parametrize("K", [24, 100, 128])
def test_wrappers_take_the_tensor_core_builds_at_ns32(K):
    """ns=32/nv=6: every edge-list layer at the ligand pairs' K=24, the
    pinned cap's 100 and the training cap's 128, the torsion convolution's
    SHD=20 included, and every rec-with-mask layer, on the tensor-core
    stage."""
    for ir_in, ir_sh, ir_out, F, H in _edge_layers(32, 6):
        assert tpconv_edge.edge_build(ir_in, ir_sh, ir_out, F, H, K) == (True, tc.TM), (ir_in, ir_out, ir_sh)
    for ir_in, _, ir_out, F, H in _edge_layers(32, 6)[:4]:
        assert tpconv_rec.rec_build(ir_in, ir_out, 32, 32, H, True) == (True, tc.TM)


def test_wrappers_keep_the_float32_builds_at_ns48():
    """ns=48/nv=10 (H=144, above KMAX = 96): every ladder layer of the
    edge-list kernel and of rec with the mask on the float32 builds, at 64
    edges a chunk where that fits and at 32 where not; the center
    convolution (F = H = 96) fits the tensor-core stage and takes it."""
    layers_ = _edge_layers(48, 10)
    for ir_in, ir_sh, ir_out, F, H in layers_[:4] + layers_[5:]:
        on_tc, cm = tpconv_edge.edge_build(ir_in, ir_sh, ir_out, F, H, 24)
        assert not on_tc and cm in (tc.TM, tc.TM_WIDE)
    assert tpconv_edge.edge_build(*layers_[4], 24) == (True, tc.TM)
    for ir_in, _, ir_out, F, H in layers_[:4]:
        on_tc, cm = tpconv_rec.rec_build(ir_in, ir_out, 48, 48, H, True)
        assert not on_tc and cm in (tc.TM, tc.TM_WIDE)
        assert tpconv_rec.rec_build(ir_in, ir_out, 48, 48, H, False) == (False, tc.TM_WIDE)


def test_the_library_has_every_build_the_host_picks():
    """``edge_build`` may pick the tensor-core stage at each harmonic width
    ``sh_dim`` takes (4, 9, 20): the edge library instantiates its
    tensor-core kernel at each, with and without the mask, and rec's has
    its training variant's tensor-core kernel."""
    csrc = os.path.join(os.path.dirname(tc.__file__), "..", "..", "csrc")
    with open(os.path.join(csrc, "tpconv_edge.cu")) as f:
        edge = f.read()
    for shd in (4, 9, 20):
        for dm in ("true", "false"):
            assert f"launch_edges_tc<{shd}, {dm}>" in edge
            assert f"tpconv_edge_tc_kernel<{shd}, {dm}>" in edge  # counted in cbt_static_smem_bytes
    with open(os.path.join(csrc, "tpconv_rec.cu")) as f:
        assert re.search(r"rec_tile<4, true, true>", f.read())
    with open(os.path.join(csrc, "tpconv_engine.cuh")) as f:
        assert "constexpr int DS = SHD == 4 ? 3 : SHD == 9 ? 5 : 7;" in f.read()  # contributions_tc to l = 3
