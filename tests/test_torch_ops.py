"""The port's graph builders, geometry, torsion and pose updates, schedules,
score-norm tables, config and complex padding against the JAX package's.

Same numpy inputs through both. Float32 results agree within 1e-5 unless a
test says otherwise; top-k neighbour lists are compared as sets (lax.top_k
and torch.topk may order ties differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu import config as jconfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.ops import geometry as jgeo
from confidence_bootstrapping_tpu.ops import graph_builders as jgb
from confidence_bootstrapping_tpu.ops import poses as jposes
from confidence_bootstrapping_tpu.ops import schedules as jsched
from confidence_bootstrapping_tpu.ops import so3 as jso3
from confidence_bootstrapping_tpu.ops import torsion as jtorsion
from confidence_bootstrapping_tpu.ops import torus as jtorus
from confidence_bootstrapping_tpu_torch import config
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.ops import geometry, graph_builders, poses, schedules, so3, torsion, torus
from test_torch_common import PKL

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.as_tensor


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _points(seed, *shape, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape, 3) * scale).astype(np.float32)


# ---------------------------------------------------------------- graph builders


def test_pairwise_dist_and_radius_mask():
    a, b = _points(0, 2, 9), _points(1, 2, 11)
    am, bm = np.random.RandomState(2).rand(2, 9) > 0.2, np.random.RandomState(3).rand(2, 11) > 0.2
    np.testing.assert_allclose(_np(graph_builders.pairwise_dist(T(a), T(b))), jgb.pairwise_dist(a, b), **TOL)
    for exclude_self in (False, True):
        m, d = graph_builders.radius_mask(T(a), T(a), 4.0, T(am), T(am), exclude_self)
        jm, jd = jgb.radius_mask(a, a, 4.0, am, am, exclude_self)
        np.testing.assert_array_equal(_np(m), jm)
    cut = np.array([3.0, 6.0], np.float32)[:, None, None]  # per-graph cutoffs
    m, _ = graph_builders.radius_mask(T(a), T(b), T(cut), T(am), T(bm))
    np.testing.assert_array_equal(_np(m), jgb.radius_mask(a, b, cut, am, bm)[0])


def test_topk_neighbors_match_as_sets():
    a, b = _points(4, 2, 8), _points(5, 2, 40, scale=6.0)
    am, bm = np.ones((2, 8), bool), np.random.RandomState(6).rand(2, 40) > 0.1
    idx, mask, dist = graph_builders.topk_neighbors(T(a), T(b), 9.0, T(am), T(bm), 12)
    jidx, jmask, jdist = jgb.topk_neighbors(a, b, 9.0, am, bm, 12)
    np.testing.assert_array_equal(_np(mask).sum(-1), np.asarray(jmask).sum(-1))
    assert _np(mask).sum() > 0 and (~_np(mask)).sum() > 0  # some rows overflow the radius, some the cap
    for i in np.ndindex(2, 8):
        assert set(_np(idx)[i][_np(mask)[i]]) == set(np.asarray(jidx)[i][np.asarray(jmask)[i]])
    np.testing.assert_allclose(np.sort(np.where(_np(mask), _np(dist), 0), -1),
                               np.sort(np.where(jmask, jdist, 0), -1), **TOL)


def test_gather_and_scatter_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 10, 5).astype(np.float32)
    idx = rng.randint(0, 10, (2, 6, 4))
    np.testing.assert_array_equal(_np(graph_builders.gather_nodes(T(x), T(idx))), jgb.gather_nodes(x, idx))
    vals = rng.randn(2, 30, 5).astype(np.float32)
    dst = rng.randint(0, 10, (2, 30))
    mask = rng.rand(2, 30) > 0.3
    s, c = graph_builders.scatter_mean_to_nodes(T(vals), T(dst), T(mask), 10)
    js, jc = jgb.scatter_mean_to_nodes(vals, dst, mask, 10)
    np.testing.assert_allclose(_np(s), js, **TOL)
    np.testing.assert_array_equal(_np(c), jc)
    np.testing.assert_array_equal(_np(graph_builders.scatter_count_to_nodes(T(dst), T(mask), 10)),
                                  jgb.scatter_count_to_nodes(dst, mask, 10))


# ---------------------------------------------------------------- geometry, torsions, poses


def test_axis_angle_to_matrix_matches_jax():
    v = _points(8, 16, scale=1.5)
    v[0] = 0.0
    v[1] = 1e-8  # the small-angle branch
    np.testing.assert_allclose(_np(geometry.axis_angle_to_matrix(T(v))), jgeo.axis_angle_to_matrix(v), **TOL)


def test_kabsch_matches_jax():
    rng = np.random.RandomState(9)
    A = _points(10, 3, 12)
    q = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(3)])
    q *= np.sign(np.linalg.det(q))[:, None, None]
    Bp = (A @ q.transpose(0, 2, 1) + rng.randn(3, 1, 3) + rng.randn(3, 12, 3) * 0.1).astype(np.float32)
    mask = rng.rand(3, 12) > 0.2
    R, t = geometry.rigid_transform_kabsch(T(A), T(Bp), T(mask))
    jR, jt = jgeo.rigid_transform_kabsch(A, Bp, mask)
    np.testing.assert_allclose(_np(R), jR, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(t), jt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(geometry.kabsch_align(T(A), T(Bp), T(mask))), jgeo.kabsch_align(A, Bp, mask),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(_np(R)), 1.0, atol=1e-5)


def _ligand(padded, B, seed):
    rng = np.random.RandomState(seed)
    pos = padded["lig_pos"][None] + rng.randn(B, *padded["lig_pos"].shape).astype(np.float32) * 0.2
    rep = lambda k: np.repeat(padded[k][None], B, 0)
    return pos.astype(np.float32), rep("lig_mask"), rep("tor_src"), rep("tor_dst"), rep("mask_rotate"), rep("tor_mask")


@pytest.fixture(scope="module")
def padded():
    hc = tcg.load_host_complex(PKL)
    return tcg.pad_complex(hc, tcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)), 0)


def test_apply_torsion_updates_matches_jax(padded):
    pos, _, src, dst, mrot, tmask = _ligand(padded, 3, 11)
    upd = np.random.RandomState(12).uniform(-np.pi, np.pi, src.shape).astype(np.float32)
    got = torsion.apply_torsion_updates(T(pos), T(src), T(dst), T(mrot), T(upd), T(tmask))
    want = jtorsion.apply_torsion_updates(pos, src, dst, mrot, upd, tmask)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_torsions", [True, False])
def test_modify_conformer_matches_jax(padded, with_torsions):
    pos, lmask, src, dst, mrot, tmask = _ligand(padded, 3, 13)
    rng = np.random.RandomState(14)
    tr, rot = rng.randn(3, 3).astype(np.float32), rng.randn(3, 3).astype(np.float32) * 0.5
    tor = rng.randn(*src.shape).astype(np.float32) if with_torsions else None
    got = poses.modify_conformer(T(pos), T(lmask), T(tr), T(rot), None if tor is None else T(tor), T(src), T(dst),
                                 T(mrot), T(tmask))
    want = jposes.modify_conformer(pos, lmask, tr, rot, tor, src, dst, mrot, tmask)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- schedules and score norms


def test_schedules_match_jax():
    sp, jsp = schedules.SigmaParams(), jsched.SigmaParams()
    assert tuple(sp) == tuple(jsp)
    t = np.linspace(0, 1, 11).astype(np.float32)
    for a, b in zip(schedules.t_to_sigma(T(t), T(t), T(t), sp), jsched.t_to_sigma(t, t, t, jsp)):
        np.testing.assert_allclose(_np(a), b, **TOL)
    np.testing.assert_array_equal(schedules.get_t_schedule(20), jsched.get_t_schedule(20))
    emb = schedules.get_timestep_embedding("sinusoidal", 32, 1000)(T(t))
    jemb = jsched.get_timestep_embedding("sinusoidal", 32, 1000)(jnp.asarray(t))
    np.testing.assert_allclose(_np(emb), jemb, rtol=1e-5, atol=1e-4)  # sin of arguments up to 1000


@pytest.mark.parametrize("name", ["so3", "torus"])
def test_score_norm_rows_match_jax_tables(name):
    """The port builds the score-norm rows with the JAX package's series in
    float64 torch; selected rows agree with the JAX tables (float32) to 1e-5
    relative. The lookup gathers the same rows."""
    mod, grid, jtable = {
        "so3": (so3, so3.eps_grid(), np.asarray(jso3.EXP_SCORE_NORM)),
        "torus": (torus, torus.sigma_grid(), np.asarray(jtorus.SCORE_NORM_TABLE)),
    }[name]
    rows = np.array([0, 1, 7, 300, len(grid) // 2, len(grid) - 2, len(grid) - 1])
    got = mod.build_score_norm(grid[rows]).numpy()
    np.testing.assert_allclose(got, jtable[rows], rtol=1e-5, atol=0)
    x = torch.as_tensor(np.geomspace(grid[0] * 0.5, grid[-1] * 2, 50).astype(np.float32))
    idx = so3.eps_index(x) if name == "so3" else torus.sigma_index(x)
    jidx = jso3._eps_index(jnp.asarray(x.numpy())) if name == "so3" else jtorus._sigma_index(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(_np(idx), jidx)


def test_score_norm_lookup_reads_the_cached_table(tmp_path, monkeypatch):
    """score_norm builds its table once, lazily, and caches it on disk."""
    calls = []

    def fake_build(eps=None, device="cpu"):
        calls.append(device)
        return torch.arange(so3.N_EPS, dtype=torch.float64)

    monkeypatch.setenv("CBT_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(so3, "build_score_norm", fake_build)
    so3._table.cache_clear()
    try:
        eps = torch.tensor([so3.MIN_EPS, so3.MAX_EPS])
        np.testing.assert_array_equal(_np(so3.score_norm(eps)), [0, so3.N_EPS - 1])
        so3._table.cache_clear()
        so3.score_norm(eps)
        assert len(calls) == 1 and list(tmp_path.iterdir())
    finally:
        so3._table.cache_clear()


# ---------------------------------------------------------------- config and complexes


def test_config_matches_jax():
    cfg, jcfg = config.ScoreModelConfig(), jconfig.ScoreModelConfig()
    for f in config.ScoreModelConfig.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for n in (48, 128, 256, 416, 512, 1024, 3072):
        assert cfg.effective_cross_cap(n) == jcfg.effective_cross_cap(n)
    assert [cfg.effective_cross_cap(n) for n in (512, 256, 128)] == [128, 64, 48]
    scfg, jscfg = config.SamplerConfig(), jconfig.SamplerConfig()
    for f in config.SamplerConfig.__dataclass_fields__:
        assert getattr(scfg, f) == getattr(jscfg, f), f


@pytest.mark.parametrize("lm_dim", [0, 16])
def test_load_and_pad_match_jax(lm_dim):
    """The committed featurization cache read without the JAX package pads
    to the same arrays as the JAX package's own pad_complex."""
    import pickle

    hc = tcg.load_host_complex(PKL)
    with open(PKL, "rb") as f:
        jhc = pickle.load(f)[0]
    assert hc.name == jhc.name and (len(hc.lig_f), len(hc.rec_f)) == (23, 416)
    for f in tcg.HostComplex._fields:
        a, b = getattr(hc, f), getattr(jhc, f)
        assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b)), f
    if lm_dim:
        lm = np.random.RandomState(0).randn(416, lm_dim).astype(np.float32)
        hc, jhc = hc._replace(rec_lm=lm), jhc._replace(rec_lm=lm)
    bucket = tcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))
    assert tuple(bucket) == tuple(jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src),
                                                  len(hc.rec_f)))
    assert (bucket.L, bucket.N) == (24, 512)
    got, want = tcg.pad_complex(hc, bucket, lm_dim), jcg.pad_complex(jhc, jcg.Bucket(*bucket), lm_dim)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k].astype(v.dtype), err_msg=k)
    b = tcg.replicate_complex(got, 3, device="cpu").set_time(0.3, 0.4, 0.5)
    assert b.batch_size == 3 and b.lig_pos.shape == (3, 24, 3) and b.rec_nbr.dtype == torch.int64
    np.testing.assert_allclose(_np(b.t_tor), [0.5] * 3)
