"""The port's lmax=2 TP-conv plain versions against the JAX package.

``tpconv_rec_g_plain`` and ``tpconv_cross_g_plain`` (what the CUDA wrappers
run for CPU tensors) get the same numpy inputs as

* the JAX package's XLA composition (gather, ``spherical_harmonics``, edge
  MLP, ``WeightedTensorProduct``; ``_xla_reference_g`` of
  tests/test_pallas_tpconv.py), at rtol = atol = 2e-4, the JAX package's
  float32 kernel bar;
* the Pallas kernels run as tests/test_pallas_tpconv.py runs them
  (interpret=True, use_bf16=False), at their own 3e-4: they split positions
  into bf16 halves, about 1e-4 from a float32 composition.

The kernels' tables at lmax=2 are held against ``WeightedTensorProduct``; at
lmax=1 they are the tables the score model's kernels were built with. The
CUDA kernels are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops.graph_builders import gather_nodes as jgather
from confidence_bootstrapping_tpu.ops.irreps import spherical_harmonics as jsh
from confidence_bootstrapping_tpu.ops.pallas import tpconv_g as jtpg
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common, tpconv_g
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct, clebsch_gordan, spherical_harmonics
from test_pallas_tpconv import _xla_reference_g

SH2 = "1x0e + 1x1o + 1x2e"
SMALL = "8x0e + 3x1o + 3x1e + 2x0o"
CONF_TRUNK = "24x0e + 6x1o + 6x1e + 24x0o"  # the confidence model's widest layer, 84 -> 84
XLA_TOL = dict(rtol=2e-4, atol=2e-4)
PALLAS_TOL = dict(rtol=3e-4, atol=3e-4)


def _ns(irreps):
    return int(irreps.split("x")[0])


def _weights(rng, F, H, W):
    return [rng.randn(F, H).astype(np.float32) * 0.2, rng.randn(H).astype(np.float32) * 0.1,
            rng.randn(H, W).astype(np.float32) * 0.2, rng.randn(W).astype(np.float32) * 0.1]


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def _rec_case(irreps_in, irreps_out, B, N, K, H, seed):
    rng = np.random.RandomState(seed)
    ns = _ns(irreps_in)
    tp = WeightedTensorProduct(irreps_in, SH2, irreps_out)
    node = rng.randn(B, N, tp.irreps_in.dim).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 5).astype(np.float32)
    nbr = rng.randint(0, N, (B, N, K)).astype(np.int32)
    mask = rng.rand(B, N, K) > 0.3
    nbr[0, 3, 1] = 3  # a self-edge, masked: zero vector, no message
    mask[0, 3, 1] = False
    mask[1, 8:16] = False  # a wholly masked receiver tile (tile_n=8)
    emb = rng.randn(B, N, K, ns).astype(np.float32)
    sig = (rng.randn(B, ns) * 0.3).astype(np.float32)  # the sigma embedding, added to emb
    return (node, pos, nbr, emb, sig, mask, *_weights(rng, 3 * ns, H, tp.weight_numel)), ns


@pytest.mark.parametrize("irreps_in,irreps_out,K,H", [(SMALL, SMALL, 4, 28), ("8x0e + 3x1o", SMALL, 5, 24),
                                                     (CONF_TRUNK, CONF_TRUNK, 3, 72)])
def test_rec_g_plain_matches_xla_and_pallas(irreps_in, irreps_out, K, H):
    B, N = 2, 16
    args, ns = _rec_case(irreps_in, irreps_out, B, N, K, H, seed=41)
    node, pos, nbr, emb, sig, mask, w1, b1, w2, b2 = args
    got = tpconv_g.fused_tpconv_rec_g(*map(_torch, args), irreps_in, SH2, irreps_out, ns)

    sender, spos = jgather(jnp.asarray(node), jnp.asarray(nbr)), jgather(jnp.asarray(pos), jnp.asarray(nbr))
    sh = jsh(SH2, spos - pos[:, :, None, :])
    eattr = jnp.concatenate([emb + sig[:, None, None, :], jnp.broadcast_to(node[:, :, None, :ns], sender[..., :ns].shape),
                             sender[..., :ns]], axis=-1)
    flat = lambda a: a.reshape((B * N, K) + a.shape[3:])
    want, _ = _xla_reference_g(flat(eattr), flat(sender), flat(sh), jnp.asarray(mask).reshape(B * N, K), w1, b1, w2,
                               b2, irreps_in, SH2, irreps_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, N, -1), **XLA_TOL)

    pallas = jtpg.fused_tpconv_rec_g(*args, irreps_in, SH2, irreps_out, ns, tile_n=8, interpret=True, use_bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **PALLAS_TOL)
    assert float(got[1, 8:16].abs().max()) == 0.0


@pytest.mark.parametrize("irreps_in,irreps_out,K,H", [(SMALL, SMALL, 4, 28), (CONF_TRUNK, CONF_TRUNK, 6, 72)])
def test_cross_g_plain_matches_xla_and_pallas(irreps_in, irreps_out, K, H):
    rng = np.random.RandomState(43)
    ns = _ns(irreps_in)
    B, L, N = 2, 8, 32
    tp = WeightedTensorProduct(irreps_in, SH2, irreps_out)
    D = tp.irreps_in.dim
    recv = rng.randn(B, L, D).astype(np.float32)
    rpos = (rng.randn(B, L, 3) * 5).astype(np.float32)
    src = rng.randn(B, N, D).astype(np.float32)
    spos = (rng.randn(B, N, 3) * 5).astype(np.float32)
    idx = rng.randint(0, N, (B, L, K)).astype(np.int32)
    emb = rng.randn(B, L, K, ns).astype(np.float32)
    mask = rng.rand(B, L, K) > 0.3
    mask[1, :3] = False  # receivers with no sender: zero sums
    idx[1, :3] = 0  # a cropped sender keeps index 0 and a false mask
    args = (recv, rpos, src, spos, idx, emb, mask, *_weights(rng, 3 * ns, H, tp.weight_numel))
    got = tpconv_g.fused_tpconv_cross_g(*map(_torch, args), irreps_in, SH2, irreps_out, ns)

    sender, sp = jgather(jnp.asarray(src), jnp.asarray(idx)), jgather(jnp.asarray(spos), jnp.asarray(idx))
    sh = jsh(SH2, sp - rpos[:, :, None, :])
    eattr = jnp.concatenate([emb, jnp.broadcast_to(recv[:, :, None, :ns], sender[..., :ns].shape), sender[..., :ns]],
                            axis=-1)
    flat = lambda a: a.reshape((B * L, K) + a.shape[3:])
    want, _ = _xla_reference_g(flat(eattr), flat(sender), flat(sh), jnp.asarray(mask).reshape(B * L, K), *args[7:],
                               irreps_in, SH2, irreps_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, L, -1), **XLA_TOL)

    pallas = jtpg.fused_tpconv_cross_g(*args, irreps_in, SH2, irreps_out, ns, interpret=True, use_bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **PALLAS_TOL)
    assert float(got[1, :3].abs().max()) == 0.0


def test_kernel_harmonics_match_spherical_harmonics():
    """The kernels' harmonics (sh_kernel, as csrc/tpconv_engine.cuh computes
    them) against the port's and the JAX package's spherical_harmonics,
    component for component; a zero vector gives zero in every l >= 1
    component (padded atoms sit at the origin)."""
    rng = np.random.RandomState(5)
    v = (rng.randn(64, 3) * 4).astype(np.float32)
    v[0] = 0.0
    got = tpconv_common.sh_kernel(torch.as_tensor(v), SH2)
    np.testing.assert_allclose(got[1:].numpy(), spherical_harmonics(2, torch.as_tensor(v[1:])).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(jsh(SH2, jnp.asarray(v[1:]))), rtol=1e-5, atol=1e-5)
    assert got[0, 0] == 1.0 and not got[0, 1:].any()
    torch.testing.assert_close(tpconv_common.sh_kernel(torch.as_tensor(v), tpconv_common.SH_IRREPS),
                               tpconv_common.sh1(torch.as_tensor(v)), rtol=0, atol=0)


# sha256 (first 20 hex digits) of the integer tables, scales and sizes of the
# score model's lmax=1 layouts, as the lmax=1 kernels were first built with
LMAX1_TABLES = {
    ("32x0e", "32x0e + 6x1o"): "db7bba31177b74d04e3f",
    ("32x0e + 6x1o + 6x1e + 6x0o", "32x0e + 6x1o + 6x1e + 6x0o"): "0bdabdf31cb828dacadb",
    ("32x0e + 6x1o + 6x1e + 6x0o", "2x1o + 2x1e"): "d618542fde139efd0d1b",
}


@pytest.mark.parametrize("pair", sorted(LMAX1_TABLES))
def test_lmax1_tables_unchanged(pair):
    """Taking the harmonics as an argument leaves the lmax=1 tables bit for
    bit as they were: integer tables, scales and sizes by digest, CG values
    equal to the float32 CG tensors they are cut from."""
    tp = WeightedTensorProduct(pair[0], tpconv_common.SH_IRREPS, pair[1])
    ref = np.concatenate([clebsch_gordan(tp.irreps_in[i].ir.l, tp.irreps_sh[s].ir.l, tp.irreps_out[g.out_index].ir.l)
                          .ravel() * np.sqrt(tp.irreps_out[g.out_index].ir.dim) for g in tp.groups for i, s in g.paths])
    for lay in (tpconv_common.tp_layout(*pair), tpconv_common.tp_layout(*pair, tpconv_common.SH_IRREPS)):
        h = hashlib.sha256()
        for f in lay._fields:
            if f == "cg":
                continue
            v = getattr(lay, f)
            h.update(f.encode())
            h.update(np.ascontiguousarray(v).tobytes() if isinstance(v, np.ndarray) else str(v).encode())
        assert h.hexdigest()[:20] == LMAX1_TABLES[pair]
        np.testing.assert_array_equal(lay.cg, ref.astype(np.float32))


@pytest.mark.parametrize("irreps_in,irreps_out", [("24x0e", "24x0e + 6x1o"), ("24x0e + 6x1o", "24x0e + 6x1o + 6x1e"),
                                                  ("24x0e + 6x1o + 6x1e", CONF_TRUNK), (CONF_TRUNK, CONF_TRUNK)])
def test_lmax2_tables_match_weighted_tp(irreps_in, irreps_out):
    """At lmax=2 the kernels' weight permutation, X table (the l=2 block at
    offset 4 of 9 harmonic components) and epilogue reproduce
    WeightedTensorProduct when evaluated in numpy; the confidence ladder's
    widths are 24/42/60/84 with W = 720/972/1224/1944."""
    lay = tpconv_common.tp_layout(irreps_in, irreps_out, SH2)
    tp = WeightedTensorProduct(irreps_in, SH2, irreps_out)
    assert (lay.din, lay.dout, lay.weight_numel) == (tp.irreps_in.dim, tp.irreps_out.dim, tp.weight_numel)
    assert sorted(lay.perm.tolist()) == list(range(tp.weight_numel))
    assert {r[2] for r in lay.xtab if r[3] == 5} == ({4} if "1o" in irreps_in else set())  # l=1 x l=2 -> l=1
    rng = np.random.RandomState(3)
    x = rng.randn(lay.din)
    sh = tpconv_common.sh_kernel(torch.as_tensor(rng.randn(3)), SH2).numpy()
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


def test_wrappers_take_only_the_harmonics_they_were_built_for():
    with pytest.raises(ValueError):  # l = 4: no kernel is built for it
        tpconv_common.tp_layout("8x0e", "8x0e", "1x0e + 1x1o + 1x2e + 1x3o + 1x4e")
    # sh_lmax = 3: the edge-list kernel and the backward take it, rec_g and cross_g (lmax 1 and 2) do not
    assert tpconv_common.sh_dim(tpconv_common.SH3_IRREPS) == 16 and not tpconv_common.gather_harmonics(
        tpconv_common.SH3_IRREPS)
    assert tpconv_common.sh_dim(SH2) == 9 and tpconv_common.sh_dim("1x0e+1x1o") == 4
    assert tpconv_g.cross_rows_per_block(64) == 1 and tpconv_g.cross_rows_per_block(32) == 2
