"""The port's training building blocks against the JAX package, on the CPU.

* so3/torus: rows of the IGSO(3) cdf/score grids and of the torus score
  table built by the port (float64 torch) against the JAX tables; sampling
  and lookups given the same uniforms and normals.
* ``train/diffusion``: ``apply_draws`` given the JAX package's draws (its key
  splits reproduced here) against ``apply_noise``; ``score_matching_loss``.
* The training ops: ``fused_tpconv_train`` and ``fused_tpconv_rec_train``
  (their plain versions, what CPU tensors run) against the JAX package's
  ``tpconv_train`` ops in interpret mode with ``use_bf16=False``: forward and
  every gradient, with and without a dropout mask, lmax 1 and 2 and the
  torsion head's 20-wide harmonics. Tolerances are the JAX package's own
  (tests/test_tpconv_train.py): 2e-4 forward, 3e-4 gradients; 1e-3 for the
  rec op, whose Pallas forward splits positions into bf16 halves.
* The edge backward kernel's tables (``tpconv_bwd.bwd_layout``): the
  kernel's arithmetic emulated in numpy from them against autograd.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.config import TrainConfig as JaxTrainConfig
from confidence_bootstrapping_tpu.ops import so3 as jso3, torus as jtorus
from confidence_bootstrapping_tpu.ops.irreps import FullTensorProduct as JFullTP
from confidence_bootstrapping_tpu.ops.irreps import spherical_harmonics as jsh
from confidence_bootstrapping_tpu.ops.pallas import tpconv_train as jtpt
from confidence_bootstrapping_tpu.ops.schedules import t_to_sigma as jt_to_sigma
from confidence_bootstrapping_tpu.train import diffusion as jdiff
from confidence_bootstrapping_tpu.train.losses import score_matching_loss as jloss
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig
from confidence_bootstrapping_tpu_torch.ops import so3, torus
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_common, tpconv_train
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct
from confidence_bootstrapping_tpu_torch.train import diffusion, losses
from test_torch_common import both_batches, install_jax_tables, padded_1a0q, port_batch

SMALL = "8x0e + 3x1o + 3x1e + 2x0o"
SH1, SH2, SH_TOR = "1x0e + 1x1o", "1x0e + 1x1o + 1x2e", tpconv_common.TOR_SH_IRREPS
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
REC_TOL = dict(rtol=1e-3, atol=1e-3)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------- tables, sampling, lookups


def test_so3_table_rows_match_jax():
    rows = np.array([0, 5, 400, 1000, 1999])
    cdf, score, norm = so3.build_tables(so3.eps_grid()[rows])
    np.testing.assert_allclose(cdf.numpy(), jso3._cdf_np[rows], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(score.numpy(), jso3._score_np[rows], rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(norm.numpy(), jso3._exp_score_norm_np[rows], rtol=1e-9)


def test_torus_score_rows_match_jax():
    rows = np.array([0, 3, 2500, 4999, 5000])
    got = torus.build_score_table(torus.sigma_grid()[rows]).numpy()
    np.testing.assert_allclose(got, jtorus._score_np[rows], rtol=1e-9, atol=1e-9)


def test_sampling_and_lookups_match_jax(monkeypatch):
    """Given the same uniforms and normals, the port's inverse-cdf angles and
    rotation vectors are the JAX package's; the score lookups agree."""
    install_jax_tables(monkeypatch)
    rng = np.random.RandomState(0)
    eps = np.geomspace(so3.MIN_EPS * 0.8, so3.MAX_EPS * 1.2, 64).astype(np.float32)
    u = rng.rand(64).astype(np.float32)
    u[:2] = [0.0, 1.0]
    normals = rng.randn(64, 3).astype(np.float32)
    omega = so3.inverse_cdf(_t(u), _t(eps))
    jrows = jso3.CDF[jso3._eps_index(jnp.asarray(eps))]
    want = jax.vmap(lambda uu, row: jnp.interp(uu, row, jso3.OMEGAS))(jnp.asarray(u), jrows)
    np.testing.assert_allclose(omega.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    vec = so3.vec_from_draws(_t(normals), omega)
    jvec = normals / (np.linalg.norm(normals, axis=-1, keepdims=True) + 1e-12) * np.asarray(want)[:, None]
    np.testing.assert_allclose(vec.numpy(), jvec, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(so3.score_vec(_t(eps), vec).numpy(),
                               np.asarray(jso3.score_vec(jnp.asarray(eps), jnp.asarray(vec.numpy()))),
                               rtol=1e-5, atol=1e-5)
    x = (rng.randn(8, 64) * 4).astype(np.float32)
    sig = np.geomspace(0.01, 6.0, 64).astype(np.float32)
    np.testing.assert_allclose(torus.score(_t(x), _t(sig)).numpy(),
                               np.asarray(jtorus.score(jnp.asarray(x), jnp.asarray(sig))), rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(3)
    sample = so3.sample_vec(_t(eps), gen)
    assert sample.shape == (64, 3) and torch.all(sample.norm(dim=-1) <= np.pi + 1e-5)


def test_beta_times_have_the_right_moments():
    """t ~ Beta(2, 1) (the TrainConfig default) and Beta(2.5, 0.7) by the
    port's own gamma sampler: means and variances within sampling error."""
    gen = torch.Generator().manual_seed(0)
    for a, b in ((2.0, 1.0), (2.5, 0.7)):
        t = diffusion.sample_beta(a, b, (200000,), gen, "cpu")
        assert abs(float(t.mean()) - a / (a + b)) < 4e-3
        assert abs(float(t.var()) - a * b / ((a + b) ** 2 * (a + b + 1))) < 2e-3
    cfg = TrainConfig(minimum_t=0.3, sampling_mixing_coeff=0.5)
    t = diffusion.sample_train_times(20000, cfg, gen, "cpu")
    assert abs(float((t < 0.3).float().mean()) - 0.5) < 0.02 and float(t.min()) >= 0.0


# ---------------------------------------------------------------- noise and loss


@pytest.fixture(scope="module")
def noised_case():
    padded = padded_1a0q(0)
    jb, tb = both_batches(padded, 3)
    key = jax.random.PRNGKey(7)
    jcfg = JaxTrainConfig()
    sigma, jsigma = ScoreModelConfig().sigma, JaxScoreConfig().sigma
    noised, targets = jdiff.apply_noise(jb, key, jsigma, jcfg)
    # the JAX package's draws, its key splits reproduced
    B, R = jb.tor_src.shape
    k_t, k_tr, k_rot, k_tor = jax.random.split(key, 4)
    t = jdiff.sample_train_times(k_t, B, jcfg)
    tr_s, rot_s, tor_s = jt_to_sigma(t, t, t, jsigma)
    draws = diffusion.NoiseDraws(
        t=_t(t), tr_update=_t(jax.random.normal(k_tr, (B, 3)) * tr_s[:, None]),
        rot_update=_t(jso3.sample_vec(k_rot, rot_s)),
        tor_updates=_t(jnp.where(jb.tor_mask, jax.random.normal(k_tor, (B, R)) * tor_s[:, None], 0.0)))
    return tb, sigma, draws, noised, targets, jsigma


def test_apply_noise_matches_jax_given_its_draws(noised_case, monkeypatch):
    install_jax_tables(monkeypatch)
    tb, sigma, draws, noised, targets, _ = noised_case
    got, tgt = diffusion.apply_draws(tb, draws, sigma)
    np.testing.assert_allclose(got.lig_pos.numpy(), np.asarray(noised.lig_pos), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.t_tr.numpy(), np.asarray(noised.t_tr), rtol=1e-6)
    for name in diffusion.ScoreTargets._fields:
        np.testing.assert_allclose(getattr(tgt, name).numpy(), np.asarray(getattr(targets, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert float(np.abs(np.asarray(targets.tor_score)).max()) > 0


def test_score_matching_loss_matches_jax(noised_case, monkeypatch):
    install_jax_tables(monkeypatch)
    tb, sigma, _, noised, targets, jsigma = noised_case
    rng = np.random.RandomState(1)
    B, R = np.asarray(noised.tor_mask).shape
    preds = [rng.randn(B, 3).astype(np.float32), rng.randn(B, 3).astype(np.float32),
             rng.randn(B, R).astype(np.float32)]
    tnoised = port_batch(noised)
    ttargets = diffusion.ScoreTargets(*map(_t, targets))
    for apply_mean in (True, False):
        got = losses.score_matching_loss(*map(_t, preds), ttargets, tnoised, sigma, 0.33, 0.33, 0.33,
                                         apply_mean=apply_mean)
        want = jloss(*map(jnp.asarray, preds), targets, noised, jsigma, 0.33, 0.33, 0.33, apply_mean=apply_mean)
        for name, a, b in zip(got._fields, got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- the training ops


def _edge_case(irreps_in, irreps_sh, irreps_out, M=6, K=5, F=12, H=10, dropout=False, seed=0):
    rng = np.random.RandomState(seed)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    vec = rng.randn(M, K, 3).astype(np.float32)
    if irreps_sh == SH_TOR:  # the torsion head's: sh1 (x) Y2 of a bond axis
        axis = jsh(2, jnp.asarray(rng.randn(M, 1, 3).astype(np.float32)))[..., 4:]
        sh = JFullTP(SH1, "1x2e")(jsh(1, jnp.asarray(vec)), jnp.broadcast_to(axis, (M, K, 5)))
    else:
        sh = jsh(1 if irreps_sh == SH1 else 2, jnp.asarray(vec))
    args = dict(
        edge_attr=rng.randn(M, K, F).astype(np.float32), sender=rng.randn(M, K, tp.irreps_in.dim).astype(np.float32),
        sh=np.asarray(sh, np.float32), mask=rng.rand(M, K) > 0.3,
        w1=(rng.randn(F, H) * 0.3).astype(np.float32), b1=(rng.randn(H) * 0.1).astype(np.float32),
        w2=(rng.randn(H, tp.weight_numel) * 0.3).astype(np.float32), b2=(rng.randn(tp.weight_numel) * 0.1).astype(np.float32))
    dmask = (rng.rand(M, K, H) > 0.25).astype(np.float32) / 0.75 if dropout else None
    return args, dmask, tp.irreps_out.dim


@pytest.mark.parametrize("sum_k", [True, False])
@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out,dropout", [
    (SMALL, SH1, SMALL, False), (SMALL, SH1, SMALL, True), (SMALL, SH2, SMALL, True),
    (SMALL, SH_TOR, "8x0o + 8x0e", True), (SMALL, SH1, "2x1o + 2x1e", False)])
def test_train_op_matches_jax(irreps_in, irreps_sh, irreps_out, dropout, sum_k):
    args, dmask, dout = _edge_case(irreps_in, irreps_sh, irreps_out, dropout=dropout)
    M, K = args["mask"].shape
    cot = np.random.RandomState(9).randn(*((M,) if sum_k else (M, K)), dout).astype(np.float32)
    names = ["edge_attr", "sender", "sh", "w1", "b1", "w2", "b2"]

    def jax_loss(*xs):
        a = dict(zip(names, xs))
        out = jtpt.fused_tpconv_train(a["edge_attr"], a["sender"], a["sh"], jnp.asarray(args["mask"]), a["w1"], a["b1"],
                                      a["w2"], a["b2"], irreps_in, irreps_sh, irreps_out,
                                      dmask=None if dmask is None else jnp.asarray(dmask), sum_k=sum_k,
                                      use_bf16=False, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(args[n]) for n in names))
    leaves = [torch.tensor(args[n], requires_grad=True) for n in names]
    a = dict(zip(names, leaves))
    got = tpconv_train.fused_tpconv_train(a["edge_attr"], a["sender"], a["sh"], _t(args["mask"]), a["w1"], a["b1"],
                                          a["w2"], a["b2"], irreps_in, irreps_sh, irreps_out,
                                          dmask=None if dmask is None else _t(dmask), sum_k=sum_k)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    grads = torch.autograd.grad(torch.sum(got * _t(cot)), leaves)
    for name, g, w in zip(names, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("sh_irreps,dropout", [(SH1, False), (SH1, True), (SH2, True)])
def test_rec_train_op_matches_jax(sh_irreps, dropout):
    ns, B, N, K, H = 8, 2, 16, 4, 12
    tp = WeightedTensorProduct(SMALL, sh_irreps, SMALL)
    rng = np.random.RandomState(7)
    args = dict(node_attr=rng.randn(B, N, tp.irreps_in.dim).astype(np.float32),
                pos=(rng.randn(B, N, 3) * 5).astype(np.float32),
                edge_emb=rng.randn(B, N, K, ns).astype(np.float32), sig=rng.randn(B, ns).astype(np.float32),
                w1=(rng.randn(3 * ns, H) * 0.2).astype(np.float32), b1=(rng.randn(H) * 0.1).astype(np.float32),
                w2=(rng.randn(H, tp.weight_numel) * 0.2).astype(np.float32),
                b2=(rng.randn(tp.weight_numel) * 0.1).astype(np.float32))
    nbr = (np.arange(N)[None, :, None] + rng.randint(1, N, (B, N, K))) % N  # no self-edges: JAX's d_pos is NaN there
    mask = rng.rand(B, N, K) > 0.3
    dmask = (rng.rand(B, N, K, H) > 0.25).astype(np.float32) / 0.75 if dropout else None
    cot = rng.randn(B, N, tp.irreps_out.dim).astype(np.float32)
    names = list(args)

    def jax_loss(*xs):
        a = dict(zip(names, xs))
        out = jtpt.fused_tpconv_rec_train(a["node_attr"], a["pos"], jnp.asarray(nbr, jnp.int32), a["edge_emb"], a["sig"],
                                          jnp.asarray(mask), a["w1"], a["b1"], a["w2"], a["b2"], SMALL, sh_irreps,
                                          SMALL, ns, dmask=None if dmask is None else jnp.asarray(dmask),
                                          use_bf16=False, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(args[n]) for n in names))
    leaves = [torch.tensor(args[n], requires_grad=True) for n in names]
    a = dict(zip(names, leaves))
    got = tpconv_train.fused_tpconv_rec_train(a["node_attr"], a["pos"], _t(nbr), a["edge_emb"], a["sig"], _t(mask),
                                              a["w1"], a["b1"], a["w2"], a["b2"], SMALL, sh_irreps, SMALL, ns,
                                              dmask=None if dmask is None else _t(dmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **REC_TOL)
    grads = torch.autograd.grad(torch.sum(got * _t(cot)), leaves)
    for name, g, w in zip(names, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **REC_TOL)
    # a masked self-edge (a zero vector) leaves every gradient finite
    nbr[0, 3, 1], mask[0, 3, 1] = 3, False
    out = tpconv_train.fused_tpconv_rec_train(a["node_attr"], a["pos"], _t(nbr), a["edge_emb"], a["sig"], _t(mask),
                                              a["w1"], a["b1"], a["w2"], a["b2"], SMALL, sh_irreps, SMALL, ns)
    assert all(torch.isfinite(g).all() for g in torch.autograd.grad(torch.sum(out * _t(cot)), leaves))


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out,dropout", [
    (SMALL, SH1, SMALL, True), (SMALL, SH2, SMALL, False), (SMALL, SH_TOR, "8x0o + 8x0e", True),
    ("32x0e + 6x1o + 6x1e + 6x0o", SH1, "32x0e + 6x1o + 6x1e + 6x0o", False)])
def test_edge_bwd_tables_reproduce_autograd(irreps_in, irreps_sh, irreps_out, dropout):
    """The backward kernel's arithmetic, step for step from its tables (w2 in
    canonical order with 1/sqrt(fan) folded in, bcol, the column-segment
    epilogue, the CG rows of vtab), emulated in numpy, against autograd of
    the plain per-edge messages (``edge_bwd_plain``). The widest case is the
    score trunk's 74 -> 74 layer (W = 1660, 26 column tiles)."""
    args, dmask, dout = _edge_case(irreps_in, irreps_sh, irreps_out, M=3, K=2, dropout=dropout, seed=4)
    T = 6
    z, x, sh = (args[n].reshape(T, -1).astype(np.float64) for n in ("edge_attr", "sender", "sh"))
    g = np.random.RandomState(5).randn(T, dout)
    dm = np.ones((T, 1)) if dmask is None else dmask.reshape(T, -1).astype(np.float64)
    w1, b1, w2, b2 = (args[n].astype(np.float64) for n in ("w1", "b1", "w2", "b2"))
    lay = tpconv_common.tp_layout(irreps_in, irreps_out, irreps_sh)
    bl = tpconv_bwd.bwd_layout(irreps_in, irreps_out, irreps_sh)
    W, TN = lay.weight_numel, tpconv_common.TN
    w2c, b2c = np.zeros((w2.shape[0], lay.wpad)), np.zeros(lay.wpad)
    w2c[:, :W], b2c[:W] = w2 * bl.cscale, b2 * bl.cscale
    h = np.maximum(z @ w1 + b1, 0) * dm
    X = np.array([[sum(x[e, r[0] + p] * sh[e, r[2] + q] * lay.cg[r[6] + (p * r[3] + q) * r[4] + r[5]]
                       for p in range(r[1]) for q in range(r[3])) for r in lay.xtab] for e in range(T)])
    w = h @ w2c + b2c
    dw = np.array([[sum(g[e, gb + c] * X[e, xb + c] for c in range(do)) for xb, gb, do in bl.bcol] for e in range(T)])
    dX = np.zeros_like(X)
    for t in range(lay.n_tiles):
        for lo, hi, gb, step, xi in bl.bepi[bl.bepi_start[t]: bl.bepi_start[t + 1]]:
            dX[:, xi] += sum(w[:, t * TN + n] * g[:, gb + (n - lo) * step] for n in range(lo, hi))
    vec = np.zeros((T, lay.din + sh.shape[1]))
    for o in range(vec.shape[1]):
        other = sh if o < lay.din else x
        for s, base, n, ci, cs in bl.vtab[bl.vtab_start[o]: bl.vtab_start[o + 1]]:
            vec[:, o] += dX[:, s] * sum(other[:, base + q] * lay.cg[ci + q * cs] for q in range(n))
    dh = (dw @ w2c.T) * dm * (h > 0)
    emulated = [dh @ w1.T, vec[:, :lay.din], vec[:, lay.din:], z.T @ dh, dh.sum(0), (h.T @ dw)[:, :W] * bl.cscale,
                dw.sum(0)[:W] * bl.cscale]
    want = tpconv_bwd.edge_bwd(*map(torch.as_tensor, (args["edge_attr"].reshape(T, -1), args["sender"].reshape(T, -1),
                                                      args["sh"].reshape(T, -1), g.astype(np.float32))),
                               None if dmask is None else torch.as_tensor(dmask.reshape(T, -1)),
                               *map(torch.as_tensor, (args["w1"], args["b1"], args["w2"], args["b2"])),
                               irreps_in, irreps_sh, irreps_out)
    for name, a, b in zip(["d_attr", "d_sender", "d_sh", "dW1", "db1", "dW2", "db2"], emulated, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    assert sorted(bl.vtab_start.tolist()) == bl.vtab_start.tolist() and bl.bcol[W:, 2].sum() == 0


def test_kernel_harmonic_widths():
    assert tpconv_common.sh_dim(SH_TOR) == 20 and str(SH_TOR) == "1x2e + 1x1o + 1x2o + 1x3o"
    lay = tpconv_common.tp_layout(SMALL, "8x0o + 8x0e", SH_TOR)
    assert {r[2] for r in lay.xtab} == {5}  # only the 1o block (offset 5 of 20) reaches scalar outputs
