"""Conformer generation and conformer matching (host numpy and scipy).

Port of ``confidence_bootstrapping_tpu/data/conformers.py``: seed
conformers (ETKDG when rdkit imports, otherwise the input geometry with
seeded random torsions), the distance-geometry embedding of a SMILES
topology, torsion matching to a crystal pose by scipy's differential
evolution with its seed, Kabsch alignment and the dihedral tuples of the
rotatable bonds. rdkit stays optional, as in the JAX module.
"""


from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.optimize import differential_evolution

from .featurize import get_transformation_mask
from .mol_io import Molecule

try:  # pragma: no cover
    from rdkit import Chem
    from rdkit.Chem import AllChem

    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    HAVE_RDKIT = False


def _apply_torsions_np(pos, tor_src, tor_dst, mask_rotate, updates):
    pos = pos.copy()
    for k in range(len(tor_src)):
        u, v = tor_src[k], tor_dst[k]
        axis = pos[u] - pos[v]
        n = np.linalg.norm(axis)
        if n < 1e-9:
            continue
        axis = axis / n * updates[k]
        from scipy.spatial.transform import Rotation as R

        rot = R.from_rotvec(axis).as_matrix()
        sel = mask_rotate[k]
        pos[sel] = (pos[sel] - pos[v]) @ rot.T + pos[v]
    return pos


def _aligned_rmsd(a, b):
    """RMSD after optimal rigid superposition (Kabsch)."""
    ca, cb = a.mean(0), b.mean(0)
    A, B = a - ca, b - cb
    H = A.T @ B
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R = Vt.T @ np.diag([1.0, 1.0, -1.0]) @ U.T
    return float(np.sqrt(np.mean(np.sum((A @ R.T - B) ** 2, axis=1))))


def optimize_rotatable_bonds(
    mol: Molecule,
    true_pos: np.ndarray,
    seed_pos: Optional[np.ndarray] = None,
    popsize: int = 15,
    maxiter: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, float]:
    """Match a seed conformer's torsions to the crystal pose.

    Returns (matched positions, aligned RMSD). Differential evolution over
    the rotatable-bond angles, objective = superimposed RMSD (the reference
    uses RDKit's GetBestRMS; ours is plain Kabsch RMSD).
    """
    tor_src, tor_dst, mask_rotate = get_transformation_mask(mol.num_atoms, mol.bonds)
    pos0 = seed_pos if seed_pos is not None else mol.pos
    if len(tor_src) == 0:
        return pos0.copy(), _aligned_rmsd(pos0, true_pos)

    def objective(x):
        return _aligned_rmsd(_apply_torsions_np(pos0, tor_src, tor_dst, mask_rotate, x), true_pos)

    bounds = [(-np.pi, np.pi)] * len(tor_src)
    res = differential_evolution(
        objective, bounds, popsize=popsize, maxiter=maxiter, seed=seed, polish=False, tol=0.01
    )
    matched = _apply_torsions_np(pos0, tor_src, tor_dst, mask_rotate, res.x)
    return matched, float(res.fun)


def generate_conformer(mol: Molecule, seed: int = 0, randomize_torsions: bool = True) -> np.ndarray:
    """Seed conformer generation.

    RDKit present: ETKDG embedding (the reference path). Otherwise: the
    input geometry with uniformly randomized torsion angles — valid because
    bond lengths/angles are preserved and the diffusion process only ever
    modifies the (tr, rot, torsion) degrees of freedom.
    """
    if HAVE_RDKIT:  # pragma: no cover - no rdkit in this image
        rd = Chem.RWMol()
        for z in mol.atomic_nums:
            rd.AddAtom(Chem.Atom(int(z)))
        bt = {1: Chem.BondType.SINGLE, 2: Chem.BondType.DOUBLE, 3: Chem.BondType.TRIPLE, 4: Chem.BondType.AROMATIC}
        for i, j, o in mol.bonds:
            rd.AddBond(int(i), int(j), bt.get(o, Chem.BondType.SINGLE))
        m = rd.GetMol()
        try:
            Chem.SanitizeMol(m)
            ps = AllChem.ETKDGv2()
            ps.randomSeed = seed
            if AllChem.EmbedMolecule(m, ps) == 0:
                conf = m.GetConformer()
                return np.asarray([[conf.GetAtomPosition(i).x, conf.GetAtomPosition(i).y, conf.GetAtomPosition(i).z] for i in range(m.GetNumAtoms())])
        except Exception:
            pass
    pos = mol.pos.copy()
    if randomize_torsions:
        tor_src, tor_dst, mask_rotate = get_transformation_mask(mol.num_atoms, mol.bonds)
        if len(tor_src):
            rng = np.random.RandomState(seed)
            pos = _apply_torsions_np(pos, tor_src, tor_dst, mask_rotate, rng.uniform(-np.pi, np.pi, len(tor_src)))
    return pos


# single-bond covalent radii (A) for embedding targets
_COV_RADII = {1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 15: 1.07,
              16: 1.05, 17: 1.02, 35: 1.20, 53: 1.39}


def embed_molecule(mol: Molecule, seed: int = 0, maxiter: int = 300) -> np.ndarray:
    """3D coordinates for a topology-only molecule (e.g. from
    ``mol_io.parse_smiles``) — the RDKit-free stand-in for ETKDG embedding
    (reference generate_conformer, datasets/process_mols.py:591-607; with
    RDKit importable, prefer ``generate_conformer``).

    Distance-geometry-lite: L-BFGS on a harmonic pseudo-energy of
      * bond terms at covalent-radius targets,
      * 1-3 (angle) terms at ~109.5-120 degree distances,
      * a soft lower-bound repulsion (2.2 A) for topologically distant pairs.
    Geometry is approximate (ring pucker especially) — adequate for the
    diffusion process, which only ever modifies tr/rot/torsion DOFs.
    """
    from scipy.optimize import minimize

    n = mol.num_atoms
    if n == 1:
        return np.zeros((1, 3), dtype=np.float32)
    r = {i: _COV_RADII.get(int(z), 0.77) for i, z in enumerate(mol.atomic_nums)}
    bond_ij, bond_d = [], []
    adj = {i: set() for i in range(n)}
    order_map = {}
    for i, j, o in mol.bonds:
        shrink = {2: 0.87, 3: 0.78, 4: 0.91}.get(o, 1.0)
        bond_ij.append((i, j))
        bond_d.append((r[i] + r[j]) * shrink)
        adj[i].add(j)
        adj[j].add(i)
        order_map[(i, j)] = order_map[(j, i)] = o
    ang_ij, ang_d = [], []
    for c in range(n):
        nb = sorted(adj[c])
        # sp centers ~180 deg, aromatic/sp2 ~120, else tetrahedral 109.5
        omax = max((order_map[(c, x)] for x in nb), default=1)
        theta = np.pi if omax == 3 else (2 * np.pi / 3 if omax in (2, 4) else np.deg2rad(109.5))
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                i, j = nb[a], nb[b]
                d = np.sqrt(max(
                    (r[c] + r[i]) ** 2 + (r[c] + r[j]) ** 2
                    - 2 * (r[c] + r[i]) * (r[c] + r[j]) * np.cos(theta), 0.1))
                ang_ij.append((i, j))
                ang_d.append(d)
    bonded = {(min(i, j), max(i, j)) for i, j in bond_ij} | {(min(i, j), max(i, j)) for i, j in ang_ij}
    far = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n) if (i, j) not in bonded], dtype=int).reshape(-1, 2)
    bij = np.asarray(bond_ij, dtype=int)
    bd = np.asarray(bond_d)
    aij = np.asarray(ang_ij, dtype=int).reshape(-1, 2)
    ad = np.asarray(ang_d)

    def energy_grad(x):
        p = x.reshape(n, 3)
        e = 0.0
        g = np.zeros_like(p)
        for ij, d0, w in ((bij, bd, 10.0), (aij, ad, 3.0)):
            if not len(ij):
                continue
            v = p[ij[:, 0]] - p[ij[:, 1]]
            d = np.linalg.norm(v, axis=1) + 1e-9
            diff = d - d0
            e += w * np.sum(diff**2)
            gv = (2 * w * diff / d)[:, None] * v
            np.add.at(g, ij[:, 0], gv)
            np.add.at(g, ij[:, 1], -gv)
        if len(far):
            v = p[far[:, 0]] - p[far[:, 1]]
            d = np.linalg.norm(v, axis=1) + 1e-9
            pen = np.minimum(d - 2.2, 0.0)
            e += np.sum(pen**2)
            gv = (2 * pen / d)[:, None] * v
            np.add.at(g, far[:, 0], gv)
            np.add.at(g, far[:, 1], -gv)
        return e, g.ravel()

    best_pos, best_e = None, np.inf
    rng = np.random.RandomState(seed)
    for _ in range(3):
        x0 = rng.randn(n, 3).ravel() * max(1.0, n ** (1 / 3))
        res = minimize(energy_grad, x0, jac=True, method="L-BFGS-B", options=dict(maxiter=maxiter))
        if res.fun < best_e:
            best_pos, best_e = res.x.reshape(n, 3), res.fun
    return (best_pos - best_pos.mean(0)).astype(np.float32)


def mol_from_smiles(smiles: str, seed: int = 0) -> Molecule:
    """SMILES -> embedded 3D Molecule (the reference's MolFromSmiles +
    AddHs + generate_conformer pipeline, utils/inference_utils.py:227-233).
    Uses RDKit when importable, the built-in parser + distance-geometry
    embedding otherwise."""
    if HAVE_RDKIT:  # pragma: no cover - no rdkit in this image
        m = Chem.MolFromSmiles(smiles)
        if m is None:
            raise ValueError(f"RDKit could not parse SMILES {smiles!r}")
        m = AllChem.AddHs(m)
        ps = AllChem.ETKDGv2()
        ps.randomSeed = seed
        if AllChem.EmbedMolecule(m, ps) == 0:
            conf = m.GetConformer()
            pos = np.asarray([[conf.GetAtomPosition(i).x, conf.GetAtomPosition(i).y,
                               conf.GetAtomPosition(i).z] for i in range(m.GetNumAtoms())])
            bt = {Chem.BondType.SINGLE: 1, Chem.BondType.DOUBLE: 2, Chem.BondType.TRIPLE: 3,
                  Chem.BondType.AROMATIC: 4}
            bonds = [(b.GetBeginAtomIdx(), b.GetEndAtomIdx(), bt.get(b.GetBondType(), 1)) for b in m.GetBonds()]
            nums = np.asarray([a.GetAtomicNum() for a in m.GetAtoms()])
            charges = np.asarray([a.GetFormalCharge() for a in m.GetAtoms()])
            return Molecule(nums, pos.astype(np.float32), bonds, charges, smiles)
    from .mol_io import parse_smiles

    mol = parse_smiles(smiles)
    return mol.replace_pos(embed_molecule(mol, seed=seed))


def kabsch_align(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rigidly superimpose a onto b (optimal rotation + translation)."""
    ca, cb = a.mean(0), b.mean(0)
    A, B = a - ca, b - cb
    H = A.T @ B
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R = Vt.T @ np.diag([1.0, 1.0, -1.0]) @ U.T
    return A @ R.T + cb


def conformer_match(
    mol: Molecule,
    true_pos: np.ndarray,
    tries: int = 3,
    popsize: int = 15,
    maxiter: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, float]:
    """Generate seed conformers, torsion-match each to the crystal pose, and
    return the best one rigidly aligned into the crystal frame.

    Mirrors the reference training-time protocol
    (datasets/process_mols.py:609-666): ETKDG conformer -> differential
    evolution over rotatable bonds -> align onto the crystal; lowest-RMSD
    try wins. The returned positions carry seed-conformer local geometry
    (bond lengths/angles, ring pucker) — NOT the crystal's — so training
    never sees leaked crystal micro-structure. Returns
    (aligned matched positions, matching RMSD).
    """
    best_pos, best_rmsd = None, np.inf
    for t in range(max(1, tries)):
        seed_pos = generate_conformer(mol, seed=seed + t)
        matched, rmsd = optimize_rotatable_bonds(
            mol, true_pos, seed_pos=seed_pos, popsize=popsize, maxiter=maxiter, seed=seed + t
        )
        if rmsd < best_rmsd:
            best_pos, best_rmsd = matched, rmsd
    return kabsch_align(best_pos, true_pos), float(best_rmsd)


def get_dihedral_tuples(n_atoms: int, bonds) -> np.ndarray:
    """(c, a, b, d) tuples for each rotatable bond (reference
    utils/torsion.py:121-138): a neighbor of each endpoint that is not the
    other endpoint."""
    tor_src, tor_dst, _ = get_transformation_mask(n_atoms, bonds)
    adj = {i: [] for i in range(n_atoms)}
    for i, j, _ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    out = []
    for a, b in zip(tor_src, tor_dst):
        c = next(x for x in adj[a] if x != b)
        d = next(x for x in adj[b] if x != a)
        out.append((c, a, b, d))
    return np.asarray(out, dtype=np.int32).reshape(-1, 4)
