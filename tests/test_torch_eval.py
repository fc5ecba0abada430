"""The port's evaluation layer against the JAX package's: the automorphisms
of the molecular graph (as sets: the port enumerates them itself, in another
order than networkx's VF2++), the symmetry-corrected RMSD (within 1e-5 A,
float32 minima on both sides), and the metric dictionary (equal keys and
values) on seeded arrays."""

import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.eval import metrics as jmetrics
from confidence_bootstrapping_tpu.eval import rmsd as jrmsd
from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_cache
from confidence_bootstrapping_tpu_torch.eval import metrics, rmsd
from test_torch_common import PKL

ATOL = 1e-5
HC, MOL = load_host_cache(PKL)


def _ring(n=6, r=1.4):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros(n)], axis=1), [(i, (i + 1) % n, 4) for i in range(n)]


def _molecules():
    """name -> (atomic numbers, bonds, reference pose)."""
    ring, ring_bonds = _ring()
    # acetate: the carboxylate's two oxygens swap
    acetate = np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.1, 1.1, 0.0], [2.1, -1.1, 0.0]])
    # toluene with the methyl's hydrogens: the ring's mirror times the 6 orders of the hydrogens
    tol_pos = np.concatenate([ring, [[2.9, 0.0, 0.0], [3.3, 1.0, 0.0], [3.3, -0.5, 0.9], [3.3, -0.5, -0.9]]])
    tol_bonds = ring_bonds + [(0, 6, 1), (6, 7, 1), (6, 8, 1), (6, 9, 1)]
    return {
        "1a0q": (np.asarray(MOL.atomic_nums), list(MOL.bonds), np.asarray(HC.orig_lig_pos, np.float64)),
        "benzene": ([6] * 6, ring_bonds, ring),
        "carboxylate": ([6, 6, 8, 8], [(0, 1, 1), (1, 2, 2), (1, 3, 1)], acetate),
        "toluene": ([6] * 7 + [1] * 3, tol_bonds, tol_pos),
        "chain": ([6, 7, 8, 6, 7, 8, 6, 7], [(i, i + 1, 1) for i in range(7)], np.random.RandomState(0).randn(8, 3)),
    }


MOLS = _molecules()


@pytest.mark.parametrize("name", list(MOLS))
def test_automorphisms_equal_networkx(name):
    nums, bonds, _ = MOLS[name]
    got = {tuple(p) for p in rmsd.graph_automorphisms(nums, bonds)}
    want = {tuple(p) for p in jrmsd.graph_automorphisms(nums, bonds)}
    assert got == want
    assert {"1a0q": 8, "benzene": 12, "carboxylate": 2, "toluene": 12, "chain": 1}[name] == len(got)


def test_automorphisms_honour_max_count():
    nums, bonds, _ = MOLS["benzene"]
    perms = list(rmsd.graph_automorphisms(nums, bonds, max_count=5))
    assert len(perms) == 5 and len({tuple(p) for p in perms}) == 5


@pytest.mark.parametrize("name", list(MOLS))
def test_symmetry_rmsd_matches_jax(name):
    """Poses near the reference and automorphic images of it; the chain has
    the identity only, where both packages take the Hungarian fallback."""
    nums, bonds, ref = MOLS[name]
    n = len(nums)
    rng = np.random.RandomState(1)
    poses = ref[None] + rng.randn(4, n, 3) * np.array([0.3, 1.0, 2.5, 4.0])[:, None, None]
    perms = list(jrmsd.graph_automorphisms(nums, bonds))
    poses = np.concatenate([poses, ref[perms[-1]][None] + rng.randn(1, n, 3) * 0.1])
    want = jrmsd.symmetry_rmsd(ref, poses, nums, bonds)
    got = rmsd.symmetry_rmsd(ref, torch.as_tensor(poses, dtype=torch.float32), nums, bonds)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert abs(rmsd.symmetry_rmsd(ref, poses[0], nums, bonds) - jrmsd.symmetry_rmsd(ref, poses[0], nums, bonds)) <= ATOL
    if name == "chain":  # the fallback: the Hungarian assignment beats the plain RMSD on the noisiest pose
        assert got[3] < rmsd.plain_rmsd(ref, poses[3]) - 0.1


def test_symmetry_rmsd_multi_pose_reference():
    """A [P, n, 3] ground truth: the minimum over the reference poses too."""
    nums, bonds, ref = MOLS["1a0q"]
    rng = np.random.RandomState(2)
    alt = ref + np.array([6.0, -2.0, 1.0])
    refs = np.stack([ref, alt])
    poses = np.stack([ref + rng.randn(*ref.shape) * 0.5, alt + rng.randn(*ref.shape) * 0.5, ref + 3.0])
    want = jrmsd.symmetry_rmsd(refs, poses, nums, bonds)
    np.testing.assert_allclose(rmsd.symmetry_rmsd(refs, poses, nums, bonds), want, rtol=0, atol=ATOL)
    one = rmsd.symmetry_rmsd(refs, poses[1], nums, bonds)
    assert abs(one - jrmsd.symmetry_rmsd(refs, poses[1], nums, bonds)) <= ATOL


def test_hungarian_rmsd_ground_truth_and_reference_api():
    nums, bonds, ref = MOLS["1a0q"]
    pose = ref + np.random.RandomState(3).randn(*ref.shape)
    assert rmsd.hungarian_rmsd(ref, pose, nums) == jrmsd.hungarian_rmsd(ref, pose, nums)
    assert rmsd.plain_rmsd(ref, pose) == jrmsd.plain_rmsd(ref, pose)

    got = rmsd.get_symmetry_rmsd(MOL, ref, [pose, ref])
    np.testing.assert_allclose(got, jrmsd.get_symmetry_rmsd(MOL, ref, [pose, ref]), rtol=0, atol=ATOL)
    assert rmsd.ground_truth_poses(HC).shape == ref.shape
    hc2 = HC._replace(alt_orig_lig_pos=(ref + 5)[None])
    np.testing.assert_array_equal(rmsd.ground_truth_poses(hc2), jrmsd.ground_truth_poses(hc2))


def _metric_inputs(C=3, N=12, seed=4):
    rng = np.random.RandomState(seed)
    rmsds = rng.gamma(2.0, 2.0, (C, N))
    cent = rmsds * rng.uniform(0.3, 1.0, (C, N))
    conf = rng.randn(C, N)
    self_d = rng.uniform(0.2, 3.0, (C, N))
    return rmsds, cent, conf, self_d, rng.uniform(1, 5, C)


@pytest.mark.parametrize("with_conf,N,prefix", [(True, 12, ""), (False, 12, "no_overlap_"), (True, 6, "")])
def test_performance_metrics_match_jax(with_conf, N, prefix):
    rmsds, cent, conf, self_d, times = _metric_inputs(N=N)
    conf = conf if with_conf else None
    want = jmetrics.performance_metrics(rmsds, cent, conf, self_d, times, prefix=prefix)
    got = metrics.performance_metrics(rmsds, cent, conf, self_d, times, prefix=prefix)
    assert list(got) == list(want)
    assert got == want


def test_min_self_distance_matches_jax():
    nums, bonds, ref = MOLS["1a0q"]
    pose = ref + np.random.RandomState(5).randn(*ref.shape) * 0.3
    assert metrics.min_self_distance(pose, bonds) == jmetrics.min_self_distance(pose, bonds)
    assert metrics.min_self_distance(pose[:2], []) == float("inf")
