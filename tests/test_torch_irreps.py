"""The port's irreps algebra against the JAX package's (ops/irreps.py).

Same numpy inputs through both. Clebsch-Gordan tables are solved on the host
in float64 by the same procedure, so they must agree to float64 rounding;
harmonics and tensor products run in float32 and agree within 1e-5 (a few
ulps of sums over at most a few hundred terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops import irreps as jirreps
from confidence_bootstrapping_tpu_torch.ops import irreps

TOL = dict(rtol=1e-5, atol=1e-5)
LADDER = ["16x0e", "16x0e + 4x1o", "16x0e + 4x1o + 4x1e", "16x0e + 4x1o + 4x1e + 4x0o"]


@pytest.mark.parametrize("spec", LADDER + ["32x0e + 6x1o + 6x1e + 6x0o", "2x1o + 2x1e", "1x0e + 1x1o + 1x2e", "3x2o"])
def test_irreps_bookkeeping(spec):
    a, b = irreps.Irreps(spec), jirreps.Irreps(spec)
    assert str(a) == str(b) and a.dim == b.dim and a.num_irreps == b.num_irreps and a.slices() == b.slices()


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_spherical_harmonics_match_jax(lmax):
    rng = np.random.RandomState(lmax)
    v = (rng.randn(64, 3) * 3).astype(np.float32)
    v[0] = 0.0  # a zero vector (a masked self-edge) gives (1, 0, ..., 0)
    got = irreps.spherical_harmonics(lmax, torch.as_tensor(v)).numpy()
    want = np.asarray(jirreps.spherical_harmonics(lmax, jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == (64, (lmax + 1) ** 2)
    np.testing.assert_array_equal(got[0, 1:], 0.0)


@pytest.mark.parametrize("l1,l2", [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2)])
def test_clebsch_gordan_match_jax(l1, l2):
    for l3 in range(abs(l1 - l2), l1 + l2 + 1):
        np.testing.assert_allclose(irreps.clebsch_gordan(l1, l2, l3), jirreps.clebsch_gordan(l1, l2, l3),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out", [
    (LADDER[0], "1x0e + 1x1o", LADDER[1]),
    (LADDER[2], "1x0e + 1x1o", LADDER[3]),
    (LADDER[3], "1x0e + 1x1o", LADDER[3]),
    (LADDER[3], "1x0e + 1x1o", "2x1o + 2x1e"),
    (LADDER[3], "1x2e + 1x1o + 1x2o + 1x3o", "16x0o + 16x0e"),
])
def test_weighted_tensor_product_matches_jax(irreps_in, irreps_sh, irreps_out):
    """Same weight order as the JAX package: a weight vector made for one
    gives the same product in the other."""
    tp, jtp = irreps.WeightedTensorProduct(irreps_in, irreps_sh, irreps_out), jirreps.WeightedTensorProduct(
        irreps_in, irreps_sh, irreps_out)
    assert tp.weight_numel == jtp.weight_numel
    assert [(g.out_index, g.paths, g.fan_in) for g in tp.groups] == [(g.out_index, g.paths, g.fan_in) for g in jtp.groups]
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7, tp.irreps_in.dim).astype(np.float32)
    sh = rng.randn(5, 7, tp.irreps_sh.dim).astype(np.float32)
    w = rng.randn(5, 7, tp.weight_numel).astype(np.float32)
    got = tp(torch.as_tensor(x), torch.as_tensor(sh), torch.as_tensor(w)).numpy()
    want = np.asarray(jtp(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **TOL)
    # broadcasting leading axes, as the ligand pairs use it
    got_b = tp(torch.as_tensor(x[:, :1]), torch.as_tensor(sh), torch.as_tensor(w)).numpy()
    want_b = np.asarray(jtp(jnp.asarray(x[:, :1]), jnp.asarray(sh), jnp.asarray(w)))
    np.testing.assert_allclose(got_b, want_b, **TOL)


def test_full_tensor_product_matches_jax():
    """The torsion head's sh (x) Y2(bond axis) product."""
    ftp, jftp = irreps.FullTensorProduct("1x0e + 1x1o", "1x2e"), jirreps.FullTensorProduct("1x0e + 1x1o", "1x2e")
    assert str(ftp.irreps_out) == str(jftp.irreps_out)
    rng = np.random.RandomState(1)
    a = rng.randn(6, 4).astype(np.float32)
    b = rng.randn(6, 5).astype(np.float32)
    np.testing.assert_allclose(ftp(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jftp(jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_tensor_product_is_equivariant():
    """Rotating the edge vector and the input rotates the output (l <= 1
    blocks: the l=1 basis is plain (x, y, z), pseudo-vectors alike)."""
    spec = LADDER[3]
    tp = irreps.WeightedTensorProduct(spec, "1x0e + 1x1o", spec)
    rng = np.random.RandomState(2)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))
    R = torch.as_tensor(q, dtype=torch.float32)

    def rotate(x):
        out, i = [], 0
        for mul, ir in irreps.Irreps(spec):
            blk = x[..., i:i + mul * ir.dim].reshape(x.shape[:-1] + (mul, ir.dim))
            out.append((blk @ R.T if ir.l == 1 else blk).reshape(x.shape[:-1] + (-1,)))
            i += mul * ir.dim
        return torch.cat(out, -1)

    x = torch.as_tensor(rng.randn(10, tp.irreps_in.dim).astype(np.float32))
    v = torch.as_tensor(rng.randn(10, 3).astype(np.float32))
    w = torch.as_tensor(rng.randn(10, tp.weight_numel).astype(np.float32))
    sh = lambda u: irreps.spherical_harmonics(1, u)
    torch.testing.assert_close(tp(rotate(x), sh(v @ R.T), w), rotate(tp(x, sh(v), w)), rtol=1e-4, atol=1e-4)
