"""Symmetry-corrected RMSD (host-side enumeration, the minimum in torch).

Port of ``confidence_bootstrapping_tpu/eval/rmsd.py``: the RMSD between a
predicted and a reference pose minimized over the automorphisms of the
molecular graph (no superposition: docking RMSD is absolute), with the
per-element Hungarian assignment as the fallback and a wall-clock limit on
the enumeration.

The JAX package enumerates the automorphisms with networkx's VF2++; the
port's machine has no networkx, so ``graph_automorphisms`` enumerates them
itself: colour refinement (each atom's element, refined by the multiset of
its neighbours' colours until stable) restricts every atom's candidate
images, then backtracking over the atoms in breadth-first order maps each to
an unused atom of its colour whose already-mapped neighbours are exactly the
images of its own. It yields the same set as ``nx.vf2pp_all_isomorphisms``
with the element as the node label, in another order. The minimum over the
permutations (the JAX package's ``native.min_perm_rmsd``) runs in torch on
the poses' device.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

PERM_CHUNK = 1024  # permutations per step of the torch minimum


def plain_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def _adjacency(n: int, bonds) -> List[set]:
    adj = [set() for _ in range(n)]
    for i, j, _ in bonds:
        if int(i) != int(j):
            adj[int(i)].add(int(j))
            adj[int(j)].add(int(i))
    return adj


def _refined_colours(atomic_nums, adj) -> List[int]:
    """The stable colouring of colour refinement started from the elements:
    an automorphism maps every atom to one of its own colour."""
    colours = [int(z) for z in atomic_nums]
    n_classes = len(set(colours))
    while True:
        keys = [(colours[i], tuple(sorted(colours[j] for j in adj[i]))) for i in range(len(colours))]
        table = {k: c for c, k in enumerate(sorted(set(keys)))}
        colours = [table[k] for k in keys]
        if len(table) == n_classes:
            return colours
        n_classes = len(table)


def _search_order(adj) -> List[int]:
    """Every atom, breadth first from each component's first atom, so that
    each atom after a component's first has a neighbour mapped before it."""
    order, seen = [], [False] * len(adj)
    for root in range(len(adj)):
        if seen[root]:
            continue
        seen[root] = True
        queue = deque([root])
        while queue:
            i = queue.popleft()
            order.append(i)
            for j in sorted(adj[i]):
                if not seen[j]:
                    seen[j] = True
                    queue.append(j)
    return order


def graph_automorphisms(atomic_nums, bonds, max_count: int = 10000, timeout_s: float = 10.0):
    """Yield automorphism index arrays perm with perm[i] = the image of atom
    i, the identity among them; at most ``max_count``, and none after
    ``timeout_s`` seconds."""
    n = len(atomic_nums)
    adj = _adjacency(n, bonds)
    colours = _refined_colours(atomic_nums, adj)
    by_colour = {}
    for v, c in enumerate(colours):
        by_colour.setdefault(c, []).append(v)
    order = _search_order(adj)
    image = np.full(n, -1, dtype=int)
    used = [False] * n
    t0 = time.monotonic()
    count = 0

    def fits(i: int, v: int) -> bool:
        mapped = [image[u] for u in adj[i] if image[u] >= 0]
        return (all(w in adj[v] for w in mapped)
                and sum(1 for w in adj[v] if used[w]) == len(mapped))

    def extend(depth: int):
        if depth == n:
            yield image.copy()
            return
        i = order[depth]
        for v in by_colour[colours[i]]:
            if not used[v] and fits(i, v):
                image[i], used[v] = v, True
                yield from extend(depth + 1)
                image[i], used[v] = -1, False

    for perm in extend(0):
        yield perm
        count += 1
        if count >= max_count or time.monotonic() - t0 > timeout_s:
            return


def hungarian_rmsd(ref: np.ndarray, pos: np.ndarray, atomic_nums) -> float:
    """Per-element optimal assignment RMSD (ignores the bonds): the fallback."""
    nums = np.asarray(atomic_nums)
    total, count = 0.0, 0
    for z in np.unique(nums):
        idx = np.nonzero(nums == z)[0]
        d2 = np.sum((ref[idx][:, None, :] - pos[idx][None, :, :]) ** 2, axis=-1)
        r, c = linear_sum_assignment(d2)
        total += d2[r, c].sum()
        count += len(idx)
    return float(np.sqrt(total / count))


def min_perm_rmsd(ref, poses: torch.Tensor, perms: np.ndarray) -> torch.Tensor:
    """[m] float64: per pose, the least RMSD to ``ref`` [n, 3] over the
    identity and every permutation of ``perms`` [P, n] (rows of ref taken in
    the permutation's order), on the poses' device. The coordinates are
    rounded to float32 as the JAX package rounds them, the sums run in
    float64, so the card and the CPU agree to rounding at any RMSD."""
    ref = torch.as_tensor(np.asarray(ref, dtype=np.float32)).to(poses.device, torch.float64)
    poses = poses.to(torch.float32).to(torch.float64)
    best = torch.sqrt(((poses - ref) ** 2).sum(-1).mean(-1))
    perms = torch.as_tensor(np.asarray(perms, dtype=np.int64), device=poses.device)
    for lo in range(0, len(perms), PERM_CHUNK):
        alt = ref[perms[lo: lo + PERM_CHUNK]]  # [p, n, 3]
        r = torch.sqrt(((poses[:, None] - alt[None]) ** 2).sum(-1).mean(-1))  # [m, p]
        best = torch.minimum(best, r.amin(dim=1))
    return best


def symmetry_rmsd(ref, poses, atomic_nums, bonds, max_automorphisms: int = 10000, timeout_s: float = 10.0):
    """Minimum RMSD over molecular-graph automorphisms, no superposition.

    ref: [n, 3], or [P, n, 3] for a multi-pose ground truth (the minimum
    over the reference poses too). poses: [m, n, 3] or [n, 3], numpy or a
    tensor (the minimum runs on its device). Returns [m] float64 (or a
    float). Without a permutation to try (the enumeration fails, or finds
    the identity only, where the JAX package's empty permutation stack sends
    it to the same fallback) the per-pose minimum of the plain and the
    Hungarian RMSD."""
    ref = np.asarray(ref)
    poses_t = torch.as_tensor(poses) if not torch.is_tensor(poses) else poses
    if ref.ndim == 3:
        alts = [symmetry_rmsd(r, poses_t, atomic_nums, bonds, max_automorphisms, timeout_s) for r in ref]
        if poses_t.dim() == 3:
            return np.min(np.stack([np.atleast_1d(np.asarray(a, dtype=np.float64)) for a in alts]), axis=0)
        return float(min(alts))
    single = poses_t.dim() == 2
    P = poses_t[None] if single else poses_t
    try:
        perms = [p for p in graph_automorphisms(atomic_nums, bonds, max_automorphisms, timeout_s)
                 if not (p == np.arange(len(p))).all()]
    except (ValueError, IndexError):  # bonds that do not index the atoms
        perms = []
    if perms:
        best = min_perm_rmsd(ref, P, np.stack(perms)).cpu().numpy()
    else:
        host = P.detach().cpu().numpy()
        best = np.array([min(plain_rmsd(ref, p), hungarian_rmsd(ref, p, atomic_nums)) for p in host])
    return best[0] if single else best


def ground_truth_poses(hc) -> np.ndarray:
    """The ground-truth pose stack of a HostComplex: [P, n, 3] with the
    alternative binding poses when recorded, else the primary [n, 3]."""
    alt = getattr(hc, "alt_orig_lig_pos", None)
    if alt is not None and len(alt):
        return np.concatenate([np.asarray(hc.orig_lig_pos)[None], np.asarray(alt)], axis=0)
    return np.asarray(hc.orig_lig_pos)


def get_symmetry_rmsd(mol, ref_pos, pos_list, mol2=None) -> List[float]:
    """The reference's API (``utils/molecules_utils.py``): ``mol`` carries
    ``atomic_nums`` and ``bonds``; ``pos_list`` the predicted coordinates."""
    poses = np.stack([np.asarray(p) for p in pos_list])
    out = symmetry_rmsd(np.asarray(ref_pos), poses, mol.atomic_nums, mol.bonds)
    return [float(x) for x in np.atleast_1d(out)]
