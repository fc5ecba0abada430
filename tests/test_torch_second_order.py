"""The port's TP-conv engine at l=2 node blocks (the second-order irreps
ladder) and the score-model remainder's small pieces, against the JAX package.

* Routing: ``tpconv_common.is_ladder`` and ``general_route`` choose the
  kernels as the JAX package's ``tpconv.ladder_spec`` and
  ``tpconv_g.general_layout`` do (fan-in above 128: no kernel, as there).
* The kernels' tables at second-order layouts (lmax 1 and 2) evaluated in
  numpy against ``WeightedTensorProduct``; ``bwd_layout`` covers every term.
* The plain versions the CUDA wrappers run for CPU tensors (the edge-list
  sums and per-edge messages, rec_g with and without the dropout mask,
  cross_g at 4 and 9 harmonic components) against the Pallas kernels run as
  tests/test_pallas_tpconv.py runs them (interpret=True, use_bf16=False),
  within 2e-4 x max(1, max |pallas|); the training op's gradients (its
  backward: the edge backward's plain version on the CPU) against the
  Pallas custom_vjp's within rtol 2e-3.
* ``DepthwiseTensorProduct``, ``linear_apply``, ``WeightedTensorProduct``
  at l=2 node blocks, ``sidechain_losses`` and the torus ``p`` table within
  1e-6; torus ``sample`` by its moments on 10^5 draws against JAX's.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops import irreps as jirreps, torus as jtorus
from confidence_bootstrapping_tpu.ops.pallas import tpconv as jtpconv, tpconv_g as jtpg, tpconv_train as jtpt
from confidence_bootstrapping_tpu.train import losses as jlosses
from confidence_bootstrapping_tpu_torch.models.score_model import get_irrep_seq
from confidence_bootstrapping_tpu_torch.ops import irreps, torus
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_common, tpconv_edge, tpconv_g, tpconv_train
from confidence_bootstrapping_tpu_torch.train import losses

SH1, SH2 = tpconv_common.SH_IRREPS, tpconv_common.SH2_IRREPS
SEQ = get_irrep_seq(4, 1, True, use_second_order_repr=True)  # 4x0e, + 1x1o + 1x2e, + 1x1e + 1x2o, + 1x0o
LAYERS = [(SEQ[0], SEQ[1]), (SEQ[1], SEQ[2]), (SEQ[2], SEQ[3]), (SEQ[3], SEQ[3])]
REL = 2e-4


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else np.array(a))


def _weights(rng, F, H, W):
    return [rng.randn(F, H).astype(np.float32) * 0.2, rng.randn(H).astype(np.float32) * 0.1,
            rng.randn(H, W).astype(np.float32) * 0.2, rng.randn(W).astype(np.float32) * 0.1]


# ----------------------------------------------------------------------------- routing and tables


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out", [
    ("8x0e", SH1, "8x0e + 2x1o"), ("8x0e + 2x1o + 2x1e + 2x0o", SH1, "2x1o + 2x1e"), (SEQ[1], SH1, SEQ[2]),
    (SEQ[1], SH2, SEQ[2]), ("8x0e + 2x1o", SH2, "8x0e + 2x1o + 2x1e"), ("96x0e + 40x1o", SH1, "8x0e + 2x1o"),
    (SEQ[3], str(irreps.FullTensorProduct(SH1, "1x2e").irreps_out), "6x0o + 6x0e"),
])
def test_routes_follow_the_jax_gates(irreps_in, irreps_sh, irreps_out):
    """The ladder route where the JAX package's ladder_spec takes the layout
    at lmax=1; the general route where its general_layout does (a fan-in of
    136 > 128 into 0e: neither)."""
    try:
        jtpg.general_layout(irreps_in, irreps_sh, irreps_out)
        general = True
    except ValueError:
        general = False
    assert tpconv_common.general_route(irreps_in, irreps_sh, irreps_out) == general
    assert tpconv_common.is_ladder(irreps_in, irreps_out) == (jtpconv.ladder_spec(irreps_in, irreps_out) is not None)


@pytest.mark.parametrize("irreps_sh", [SH1, SH2])
@pytest.mark.parametrize("layer", range(4))
def test_tables_at_l2_node_blocks_match_weighted_tp(irreps_sh, layer):
    """The X table (input blocks of 5 components), the weight permutation and
    the epilogue reproduce WeightedTensorProduct in numpy, at TN- and
    TNC-column tiles; the backward's vtab lists every CG term once."""
    irreps_in, irreps_out = LAYERS[layer]
    tp = irreps.WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    rng = np.random.RandomState(layer)
    x = rng.randn(tp.irreps_in.dim)
    sh = tpconv_common.sh_kernel(torch.as_tensor(rng.randn(3)), irreps_sh).numpy()
    w = rng.randn(tp.weight_numel)
    want = tp(torch.as_tensor(x), torch.as_tensor(sh), torch.as_tensor(w)).numpy()
    for tn in (tpconv_common.TN, tpconv_common.TNC):
        lay = tpconv_common.tp_layout(irreps_in, irreps_out, irreps_sh, tn)
        assert max(r[1] for r in lay.xtab) == max(ir.dim for _, ir in tp.irreps_in)  # 5 from the l = 2 blocks on
        X = np.array([sum(x[r[0] + a] * sh[r[2] + b] * lay.cg[r[6] + (a * r[3] + b) * r[4] + r[5]]
                          for a in range(r[1]) for b in range(r[3])) for r in lay.xtab])
        wk = np.zeros(lay.wpad)
        wk[: tp.weight_numel] = w[lay.perm] * lay.scale
        out = np.zeros(lay.dout)
        for t in range(lay.n_tiles):
            for lo, hi, xb, step, oc in lay.epi[lay.epi_start[t]: lay.epi_start[t + 1]]:
                out[oc] += sum(wk[t * tn + n] * X[xb + (n - lo) * step] for n in range(lo, hi))
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    bl = tpconv_bwd.bwd_layout(irreps_in, irreps_out, irreps_sh)
    lay = tpconv_common.tp_layout(irreps_in, irreps_out, irreps_sh)
    assert len(bl.vtab) == sum(r[1] + r[3] for r in lay.xtab)
    assert int(bl.bcol[:, 2].max()) == max(tp.irreps_out[g.out_index].ir.dim for g in tp.groups)


# ----------------------------------------------------------------------------- plain versions against Pallas


def _edge_case(irreps_in, irreps_sh, irreps_out, M, K, H, seed):
    rng = np.random.RandomState(seed)
    tp = irreps.WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    F = 3 * int(irreps_in.split("x")[0])
    attr = rng.randn(M, K, F).astype(np.float32)
    sender = rng.randn(M, K, tp.irreps_in.dim).astype(np.float32)
    sh = np.asarray(jirreps.spherical_harmonics(irreps_sh, jnp.asarray(rng.randn(M, K, 3).astype(np.float32))))
    mask = rng.rand(M, K) > 0.3
    mask[2] = False  # a row with no edge: zero sum
    return (attr, sender, sh, mask, *_weights(rng, F, H, tp.weight_numel))


# (harmonics, layer): lmax=1 at the widest layer (134 -> 134 at full width), lmax=2 at the first with l = 2 blocks
# on both sides (the JAX package's general_layout takes seconds a layout at lmax=2)
CASES = [(SH1, 3), (SH2, 1)]


@pytest.mark.parametrize("irreps_sh,layer", CASES)
def test_edge_list_plain_matches_pallas_at_l2_node_blocks(irreps_sh, layer):
    """Row 7 (``fused_tpconv_nbr_g``/``msgs_g``) at the second-order ladder's
    layers: sums and per-edge messages, masked edges exactly zero."""
    irreps_in, irreps_out = LAYERS[layer]
    args = _edge_case(irreps_in, irreps_sh, irreps_out, 16, 5, 18, seed=layer)
    ir = (irreps_in, irreps_sh, irreps_out)
    got_sum = tpconv_edge.fused_tpconv_edge(*map(_torch, args), *ir, sum_k=True)
    got_msg = tpconv_edge.fused_tpconv_edge(*map(_torch, args), *ir, sum_k=False)
    _close(got_sum.numpy(), jtpg.fused_tpconv_nbr_g(*args, *ir, interpret=True, use_bf16=False))
    _close(got_msg.numpy(), jtpg.fused_tpconv_msgs_g(*args, *ir, interpret=True, use_bf16=False))
    assert not got_msg.numpy()[~args[3]].any() and not got_sum[2].any()


def _rec_case(irreps_in, irreps_sh, irreps_out, B, N, K, H, seed, dropout):
    rng = np.random.RandomState(seed)
    ns = int(irreps_in.split("x")[0])
    tp = irreps.WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    node = rng.randn(B, N, tp.irreps_in.dim).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 5).astype(np.float32)
    nbr = rng.randint(0, N, (B, N, K)).astype(np.int32)
    mask = rng.rand(B, N, K) > 0.3
    mask[1, 8:] = False  # a wholly masked receiver tile
    emb = rng.randn(B, N, K, ns).astype(np.float32)
    sig = (rng.randn(B, ns) * 0.3).astype(np.float32)
    dm = ((rng.rand(B, N, K, H) < 0.9) / 0.9).astype(np.float32) if dropout else None
    return (node, pos, nbr, emb, sig, mask, *_weights(rng, 3 * ns, H, tp.weight_numel)), ns, dm


@pytest.mark.parametrize("irreps_sh,layer,dropout", [(SH1, 3, False), (SH1, 3, True), (SH2, 1, False)])
def test_rec_g_plain_matches_pallas_at_l2_node_blocks(irreps_sh, layer, dropout):
    """Row 8 at the second-order ladder's layers: lmax=1 (the SHD=4 build the
    general route takes), with the dropout mask too, and lmax=2."""
    irreps_in, irreps_out = LAYERS[layer]
    args, ns, dm = _rec_case(irreps_in, irreps_sh, irreps_out, 2, 16, 4, 18, seed=7, dropout=dropout)
    got = tpconv_g.fused_tpconv_rec_g(*map(_torch, args), irreps_in, irreps_sh, irreps_out, ns,
                                      dmask=None if dm is None else _torch(dm))
    want = jtpg.fused_tpconv_rec_g(*args, irreps_in, irreps_sh, irreps_out, ns, tile_n=8, interpret=True,
                                   use_bf16=False, dmask=None if dm is None else jnp.asarray(dm))
    _close(got.numpy(), want, rel=3e-4)  # the Pallas kernel splits positions into bf16 halves
    assert float(got[1, 8:].abs().max()) == 0.0


@pytest.mark.parametrize("irreps_sh,layer", CASES)
def test_cross_g_plain_matches_pallas_at_l2_node_blocks(irreps_sh, layer):
    """Row 9 at the second-order ladder's layers, lmax 1 and 2."""
    irreps_in, irreps_out = LAYERS[layer]
    rng = np.random.RandomState(11)
    ns, B, L, N, K, H = 4, 2, 8, 24, 6, 18
    tp = irreps.WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    D = tp.irreps_in.dim
    recv, src = rng.randn(B, L, D).astype(np.float32), rng.randn(B, N, D).astype(np.float32)
    rpos, spos = (rng.randn(B, L, 3) * 5).astype(np.float32), (rng.randn(B, N, 3) * 5).astype(np.float32)
    idx = rng.randint(0, N, (B, L, K)).astype(np.int32)
    emb = rng.randn(B, L, K, ns).astype(np.float32)
    mask = rng.rand(B, L, K) > 0.3
    mask[1, :3] = False
    args = (recv, rpos, src, spos, idx, emb, mask, *_weights(rng, 3 * ns, H, tp.weight_numel))
    got = tpconv_g.fused_tpconv_cross_g(*map(_torch, args), irreps_in, irreps_sh, irreps_out, ns)
    want = jtpg.fused_tpconv_cross_g(*args, irreps_in, irreps_sh, irreps_out, ns, interpret=True, use_bf16=False)
    _close(got.numpy(), want, rel=3e-4)
    assert float(got[1, :3].abs().max()) == 0.0


@pytest.mark.parametrize("sum_k", [True, False])
def test_training_op_gradients_match_pallas_at_l2_node_blocks(sum_k):
    """Rows 10-11: the training op's forward and its gradients (the edge
    backward's plain version) against the Pallas custom_vjp's, with the
    dropout mask, at the second-order ladder's 2 -> 3 layer."""
    irreps_in, irreps_out = LAYERS[2]
    ir = (irreps_in, SH1, irreps_out)
    args = _edge_case(irreps_in, SH1, irreps_out, 12, 4, 18, seed=5)
    rng = np.random.RandomState(6)
    dm = ((rng.rand(12, 4, 18) < 0.9) / 0.9).astype(np.float32)
    g = rng.randn(*((12,) if sum_k else (12, 4)), irreps.Irreps(irreps_out).dim).astype(np.float32)
    diff = (0, 1, 2, 4, 5, 6, 7)  # attr, sender, sh and the MLP's weights

    def jfn(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return jtpt.fused_tpconv_train(*full, *ir, dmask=jnp.asarray(dm), sum_k=sum_k, use_bf16=False,
                                       interpret=True)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(args[i]) for i in diff))
    want_g = vjp(jnp.asarray(g))
    leaves = [_torch(a).requires_grad_(i in diff) if a.dtype == np.float32 else _torch(a) for i, a in enumerate(args)]
    got = tpconv_train.fused_tpconv_train(*leaves, *ir, dmask=_torch(dm), sum_k=sum_k)
    got_g = torch.autograd.grad(got, [leaves[i] for i in diff], _torch(g))
    _close(got.detach().numpy(), want)
    for i, a, b in zip(diff, got_g, want_g):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(b).max())), err_msg=i)


# ----------------------------------------------------------------------------- irreps, losses, torus


def test_depthwise_tp_linear_and_l2_weighted_tp_match_jax():
    """The depthwise ('uvu') product, the equivariant linear map after it and
    the weighted product at the second-order ladder's blocks (the 2e and 2o
    paths) within 1e-6 of the JAX package's (jitted; at lmax=1: the l = 2
    harmonics' paths are held by the models' parity tests)."""
    rng = np.random.RandomState(3)
    irreps_in, irreps_sh = SEQ[1], SH1
    x = rng.randn(5, irreps.Irreps(irreps_in).dim).astype(np.float32)
    sh = np.asarray(jirreps.spherical_harmonics(irreps_sh, jnp.asarray(rng.randn(5, 3).astype(np.float32))))
    dw, jdw = irreps.DepthwiseTensorProduct(irreps_in, irreps_sh), jirreps.DepthwiseTensorProduct(irreps_in, irreps_sh)
    assert str(dw.irreps_out) == str(jdw.irreps_out) and dw.weight_numel == jdw.weight_numel
    w = rng.randn(5, dw.weight_numel).astype(np.float32)
    mid = dw(_torch(x), _torch(sh), _torch(w))
    _close(mid.numpy(), jax.jit(jdw)(x, sh, w), rel=1e-6)
    shapes = irreps.linear_weight_shapes(str(dw.irreps_out), SEQ[2])
    assert shapes == jirreps.linear_weight_shapes(str(jdw.irreps_out), SEQ[2])
    weights = {k: rng.randn(*s).astype(np.float32) for k, s in shapes}
    biases = {"b_0": rng.randn(4).astype(np.float32)}
    got = irreps.linear_apply(str(dw.irreps_out), SEQ[2], mid, {k: _torch(v) for k, v in weights.items()},
                              {k: _torch(v) for k, v in biases.items()})
    want = jax.jit(lambda *a: jirreps.linear_apply(str(jdw.irreps_out), SEQ[2], *a))(mid.numpy(), weights, biases)
    _close(got.numpy(), want, rel=1e-6)
    tp, jtp = (m.WeightedTensorProduct(irreps_in, irreps_sh, SEQ[2]) for m in (irreps, jirreps))
    w = rng.randn(5, tp.weight_numel).astype(np.float32)
    _close(tp(_torch(x), _torch(sh), _torch(w)).numpy(), jax.jit(jtp)(x, sh, w), rel=1e-6)


def test_sidechain_losses_match_jax():
    rng = np.random.RandomState(8)
    B, N = 2, 12
    pred = rng.rand(B, N, 10).astype(np.float32)
    target = rng.rand(B, N, 10).astype(np.float32)
    target[0, :3, 2:4] = np.nan  # chi angles a residue does not have
    mask = rng.rand(B, N) > 0.2
    got = losses.sidechain_losses(_torch(pred), _torch(target), _torch(mask))
    want = jlosses.sidechain_losses(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)


def test_torus_p_and_sample_match_jax(monkeypatch):
    """p: rows of the table built here against the JAX package's at the same
    sigma grid points, and the gather at off-grid points (served from the JAX
    table, so no 5001 x 5001 build here); sample: mean, variance and the
    fraction beyond pi/2 of 10^5 draws against JAX's, within 6 standard
    errors of a difference of two independent means."""
    rows = np.array([0, 1234, 3001, 5000])
    got = torus.build_p_table(torus.sigma_grid()[rows])
    np.testing.assert_allclose(got.numpy(), np.asarray(jtorus.P_TABLE)[rows], rtol=0, atol=1e-6)
    table = torch.as_tensor(np.asarray(jtorus.P_TABLE))
    monkeypatch.setattr(torus, "_p_table", lambda device: table)
    x = torch.linspace(-6.0, 6.0, 97, dtype=torch.float32)
    np.testing.assert_allclose(torus.p(x, torch.full_like(x, 0.7)).numpy(), np.asarray(jtorus.p(x.numpy(), 0.7)),
                               rtol=0, atol=1e-6)
    n = 100_000
    for s in (0.3, 1.5, 4.0):
        a = torus.sample(torch.full((n,), s), torch.Generator().manual_seed(0)).numpy().astype(np.float64)
        b = np.asarray(jtorus.sample(jax.random.PRNGKey(0), jnp.full((n,), s)), dtype=np.float64)
        assert a.min() >= -np.pi and a.max() < np.pi
        far = lambda v: (np.abs(v) > np.pi / 2).astype(np.float64)
        for sa, sb in ((a, b), (a**2, b**2), (far(a), far(b))):
            se = np.sqrt((sa.var() + sb.var()) / n)
            assert abs(sa.mean() - sb.mean()) < 6 * se + 1e-12, s
