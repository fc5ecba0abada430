"""Host featurization: molecules and receptors -> HostComplex arrays.

Port of ``confidence_bootstrapping_tpu/data/featurize.py`` (host numpy code,
the same features, edges, torsions and receptor graphs): the ligand's 16
categorical features, bond-type edges, rotatable-bond masks, the C-alpha
receptor graph, the receptor's heavy atoms, the pocket center and
``build_host_complex`` in its three conformer modes.

The JAX module perceives rings and rotatable bonds with networkx, which the
card's machine lacks. Here ``_components`` lists connected components in the
order networkx's ``connected_components`` yields them (by lowest node), and
``minimum_cycle_basis`` is Horton's construction: every cycle made of two
shortest paths from a vertex and one edge, taken shortest first while it is
independent over GF(2) of those taken. A molecule's minimum cycle basis is
unique up to rings of equal length that share atoms (bridged cages); there
the choice of ring may differ from networkx's.
"""


from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from . import vocab
from .complex_graph import HostComplex
from .mol_io import Molecule, ProteinStructure, _DEFAULT_VALENCE

MAX_RECEPTOR_RESIDUES = 3000  # hard cap, reference process_mols.py:456-457


# ------------------------------------------------------------------ ligand


def _edges(bonds) -> List[Tuple[int, int]]:
    """Unique undirected edges (i < j) of a bond list, in first-seen order."""
    seen, out = set(), []
    for i, j, *_ in bonds:
        e = (min(int(i), int(j)), max(int(i), int(j)))
        if e[0] != e[1] and e not in seen:
            seen.add(e)
            out.append(e)
    return out


def _adjacency(n: int, edges) -> List[List[int]]:
    adj = [[] for _ in range(n)]
    for i, j in edges:
        adj[i].append(j)
        adj[j].append(i)
    return adj


def _components(n: int, edges) -> List[set]:
    """Connected components as node sets, ordered by their lowest node."""
    adj = _adjacency(n, edges)
    seen, comps = [False] * n, []
    for s in range(n):
        if seen[s]:
            continue
        seen[s] = True
        comp, stack = {s}, [s]
        while stack:
            for y in adj[stack.pop()]:
                if not seen[y]:
                    seen[y] = True
                    comp.add(y)
                    stack.append(y)
        comps.append(comp)
    return comps


def minimum_cycle_basis(n: int, edges) -> List[List[int]]:
    """A minimum cycle basis (Horton): node lists of m - n + c cycles."""
    edges = _edges(edges)
    dim = len(edges) - n + len(_components(n, edges))
    if dim <= 0:
        return []
    adj = _adjacency(n, edges)
    bit = {e: 1 << k for k, e in enumerate(edges)}

    def ebit(a, b):
        return bit[(min(a, b), max(a, b))]

    cands = []
    for v in range(n):
        parent, order = {v: None}, [v]
        for x in order:  # breadth-first: shortest-path tree from v
            for y in adj[x]:
                if y not in parent:
                    parent[y] = x
                    order.append(y)

        def path(x):
            out = [x]
            while parent[out[-1]] is not None:
                out.append(parent[out[-1]])
            return out

        for x, y in edges:
            if x not in parent or y not in parent:
                continue
            px, py = path(x), path(y)
            nodes = set(px) | set(py)
            if len(nodes) != len(px) + len(py) - 1:
                continue
            vec = ebit(x, y)
            for p in (px, py):
                for a, b in zip(p, p[1:]):
                    vec ^= ebit(a, b)
            if len(nodes) >= 3 and bin(vec).count("1") == len(nodes):
                cands.append((len(nodes), vec, sorted(nodes)))
    cands.sort(key=lambda c: c[0])
    basis, pivots = [], []  # reduced vectors with their leading bits, for the GF(2) rank test
    for _, vec, nodes in cands:
        r = vec
        for p, b in pivots:
            if r & p:
                r ^= b
        if r:
            pivots.append((r & -r, r))
            basis.append(nodes)
            if len(basis) == dim:
                break
    return basis


def _ring_info(n: int, bonds):
    """Per-atom ring counts and ring-size membership via minimum cycle basis."""
    in_ring_size = np.zeros((n, 9), dtype=bool)  # sizes 0..8 (index by size)
    ring_count = np.zeros(n, dtype=int)
    cycles = minimum_cycle_basis(n, bonds)
    for cyc in cycles:
        for a in cyc:
            ring_count[a] += 1
            if 3 <= len(cyc) <= 8:
                in_ring_size[a, len(cyc)] = True
    return ring_count, in_ring_size


def featurize_ligand(mol: Molecule, remove_hs: bool = True):
    """-> (features [l, 16] int, heavy Molecule, edge arrays).

    Feature columns follow the reference order (process_mols.py:150-168).
    """
    h_counts_full = mol.explicit_h_counts()
    heavy = mol.remove_hs() if remove_hs else mol
    keep = mol.heavy_indices() if remove_hs else np.arange(mol.num_atoms)
    h_counts = h_counts_full[keep]

    n = heavy.num_atoms
    ring_count, in_ring = _ring_info(n, heavy.bonds)

    # bond-order bookkeeping per atom
    order_sum = np.zeros(n)
    n_double = np.zeros(n, dtype=int)
    n_triple = np.zeros(n, dtype=int)
    aromatic = np.zeros(n, dtype=bool)
    heavy_degree = np.zeros(n, dtype=int)
    for i, j, o in heavy.bonds:
        heavy_degree[i] += 1
        heavy_degree[j] += 1
        if o == 4:
            aromatic[i] = aromatic[j] = True
            order_sum[i] += 1.5
            order_sum[j] += 1.5
        else:
            order_sum[i] += o
            order_sum[j] += o
            if o == 2:
                n_double[i] += 1
                n_double[j] += 1
            elif o == 3:
                n_triple[i] += 1
                n_triple[j] += 1

    feats = np.zeros((n, 16), dtype=np.int64)
    for i in range(n):
        z = int(heavy.atomic_nums[i])
        chg = int(heavy.charges[i])
        default_v = _DEFAULT_VALENCE.get(z, 4)
        # implicit Hs: whatever valence is left after explicit bonds + Hs
        implicit_h = max(0, int(round(default_v + (chg if z in (7,) else -abs(chg)) - order_sum[i] - h_counts[i])))
        total_h = int(h_counts[i] + implicit_h)
        degree = int(heavy_degree[i] + total_h)
        # hybridization heuristic from bond orders
        if n_triple[i] > 0 or n_double[i] >= 2:
            hyb = "SP"
        elif n_double[i] == 1 or aromatic[i]:
            hyb = "SP2"
        elif degree <= 4:
            hyb = "SP3"
        elif degree == 5:
            hyb = "SP3D"
        else:
            hyb = "SP3D2"
        feats[i] = [
            vocab.safe_index(vocab.ATOMIC_NUMS, z),
            0,  # chirality: unperceived without RDKit -> CHI_UNSPECIFIED
            vocab.safe_index(vocab.DEGREE, degree),
            vocab.safe_index(vocab.FORMAL_CHARGE, chg),
            vocab.safe_index(vocab.IMPLICIT_VALENCE, implicit_h),
            vocab.safe_index(vocab.NUM_H, total_h),
            vocab.safe_index(vocab.NUM_RADICAL_E, 0),
            vocab.safe_index(vocab.HYBRIDIZATION, hyb),
            int(aromatic[i]),
            vocab.safe_index(vocab.NUMRING, int(ring_count[i])),
            int(in_ring[i, 3]),
            int(in_ring[i, 4]),
            int(in_ring[i, 5]),
            int(in_ring[i, 6]),
            int(in_ring[i, 7]),
            int(in_ring[i, 8]),
        ]

    # directed bond edges + one-hot bond type (single/double/triple/aromatic)
    src, dst, attr = [], [], []
    onehot = {1: 0, 2: 1, 3: 2, 4: 3}
    for i, j, o in heavy.bonds:
        t = onehot.get(o, 0)
        for a, b in ((i, j), (j, i)):
            src.append(a)
            dst.append(b)
            v = np.zeros(4, dtype=np.float32)
            v[t] = 1.0
            attr.append(v)
    return (
        feats,
        heavy,
        np.asarray(src, dtype=np.int32),
        np.asarray(dst, dtype=np.int32),
        np.asarray(attr, dtype=np.float32).reshape(-1, 4),
    )


def get_transformation_mask(n_atoms: int, bonds: List[Tuple[int, int, int]]):
    """Rotatable-bond detection (reference utils/torsion.py:15-45).

    A bond is rotatable iff it is a bridge whose smaller side has > 1 atom.
    Returns (tor_src [r], tor_dst [r], mask_rotate [r, n]) with tor_dst on
    the rotating (smaller) side.
    """
    edges = _edges(bonds)
    src, dst, masks = [], [], []
    for i, j, _ in bonds:
        cut = (min(i, j), max(i, j))
        comps = _components(n_atoms, [e for e in edges if e != cut])
        if len(comps) == 1:
            continue
        comps = sorted(comps, key=len)
        small = comps[0]
        if len(small) < 2:
            continue
        u, v = (j, i) if i in small else (i, j)  # v sits on the rotating side
        m = np.zeros(n_atoms, dtype=bool)
        m[list(small)] = True
        src.append(u)
        dst.append(v)
        masks.append(m)
    if not src:
        return (
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32),
            np.zeros((0, n_atoms), dtype=bool),
        )
    return np.asarray(src, dtype=np.int32), np.asarray(dst, dtype=np.int32), np.stack(masks)


# ---------------------------------------------------------------- receptor


def featurize_receptor(
    structure: ProteinStructure,
    lm_embeddings: Optional[np.ndarray] = None,
    c_alpha_max_neighbors: int = 24,
    knn_only_graph: bool = True,
    receptor_radius: float = 15.0,
):
    """-> (rec_f [n], rec_pos [n,3], rec_nbr [n,K], rec_nbr_mask, lm [n,D]).

    One node per residue at the Calpha; kNN neighbor lists (the pretrained
    models use knn_only_graph with k=24, reference process_mols.py:458-459).
    """
    residues = [r for r in structure.residues if "CA" in r.atoms]
    residues = residues[:MAX_RECEPTOR_RESIDUES]
    n = len(residues)
    if n == 0:
        raise ValueError("no residues with C-alpha found")
    rec_f = np.asarray([vocab.safe_index(vocab.AMINO_ACIDS, r.name) for r in residues], dtype=np.int32)
    rec_pos = np.stack([r.atoms["CA"] for r in residues]).astype(np.float32)

    k = min(c_alpha_max_neighbors, n - 1)
    tree = cKDTree(rec_pos)
    d, idx = tree.query(rec_pos, k=k + 1)
    nbr = idx[:, 1:]  # drop self
    mask = np.ones_like(nbr, dtype=bool)
    if not knn_only_graph:
        mask = d[:, 1:] < receptor_radius
    if lm_embeddings is not None:
        if len(lm_embeddings) < n:
            raise ValueError(f"LM embeddings ({len(lm_embeddings)}) shorter than residues ({n})")
        lm = np.asarray(lm_embeddings[:n], dtype=np.float32)
    else:
        lm = np.zeros((n, 0), dtype=np.float32)
    return rec_f, rec_pos, nbr.astype(np.int32), mask, lm, residues


def featurize_receptor_atoms(
    residues,
    atom_radius: float = 5.0,
    atom_max_neighbors: int = 8,
):
    """All-atom receptor arrays for the confidence model.

    -> (atom_f [a, 4], atom_pos [a, 3], atom_nbr [a, K], atom_nbr_mask,
    atom_res [a]): features [amino acid, atomic number, atom_type_2 =
    (name + '*')[:2], atom_type_3 = name] (reference process_mols.py:558-561),
    kNN edges capped at atom_max_neighbors within atom_radius.
    """
    feats, pos, res_idx = [], [], []
    for ri, r in enumerate(residues):
        aa = vocab.safe_index(vocab.AMINO_ACIDS, r.name)
        for name, xyz in r.atoms.items():
            z = r.elements.get(name, 0)
            if z == 1:
                continue
            feats.append(
                [
                    aa,
                    vocab.safe_index(vocab.ATOMIC_NUMS, z),
                    vocab.safe_index(vocab.ATOM_TYPE_2, (name + "*")[:2]),
                    vocab.safe_index(vocab.ATOM_TYPE_3, name),
                ]
            )
            pos.append(xyz)
            res_idx.append(ri)
    atom_f = np.asarray(feats, dtype=np.int32)
    atom_pos = np.asarray(pos, dtype=np.float32)
    atom_res = np.asarray(res_idx, dtype=np.int32)
    a = len(atom_f)
    k = min(atom_max_neighbors, a - 1)
    tree = cKDTree(atom_pos)
    d, idx = tree.query(atom_pos, k=k + 1)
    nbr = idx[:, 1:].astype(np.int32)
    mask = d[:, 1:] < atom_radius
    return atom_f, atom_pos, nbr, mask, atom_res


def pocket_center(hc: HostComplex, pocket_cutoff: float = 7.0) -> np.ndarray:
    """Mean position of receptor residues within pocket_cutoff of the true
    ligand pose (pocket-aware initialization, reference sampling.py:18-27);
    falls back to the closest residue when none qualify."""
    d = np.linalg.norm(hc.rec_pos[:, None, :] - hc.orig_lig_pos[None, :, :], axis=-1)
    label = (d < pocket_cutoff).any(axis=1)
    if label.any():
        return hc.rec_pos[label].mean(axis=0)
    return hc.rec_pos[np.argmin(d.min(axis=1))]


def build_host_complex(
    name: str,
    mol: Molecule,
    structure: ProteinStructure,
    lm_embeddings: Optional[np.ndarray] = None,
    remove_hs: bool = True,
    c_alpha_max_neighbors: int = 24,
    knn_only_graph: bool = True,
    receptor_radius: float = 15.0,
    all_atoms: bool = False,
    atom_radius: float = 5.0,
    atom_max_neighbors: int = 8,
    with_sidechains: bool = False,
    chain_cutoff: Optional[float] = None,
    conformer_mode: str = "input",
    conformer_seed: int = 0,
    matching_tries: int = 3,
    matching_popsize: int = 15,
    matching_maxiter: int = 20,
) -> HostComplex:
    """Featurize one complex and center it at the receptor centroid
    (the reference centers all graphs at the receptor center,
    process_mols.py / inference_utils.py). chain_cutoff drops whole receptor
    chains with no atom within that distance of the ligand (reference
    moad.py:214-258).

    conformer_mode controls where the ligand's starting geometry comes from:

    * "input": use the file's coordinates as-is (the reference's
      ``matching=False`` branch and the only round-1 behavior);
    * "generate": replace the starting geometry with a freshly generated
      conformer (reference inference protocol, utils/inference_utils.py:
      227-243) — when the input SDF is the crystal ligand, ring pucker and
      bond geometry no longer leak from the answer. ``orig_lig_pos`` keeps
      the input coordinates as the evaluation ground truth;
    * "match": conformer-match a generated conformer's torsions to the
      input pose and use the aligned result as BOTH the start geometry and
      the regression target (reference training protocol,
      datasets/process_mols.py:609-666); the crystal pose stays in
      ``orig_lig_pos`` and the matching RMSD is recorded on the complex.
    """
    feats, heavy, esrc, edst, eattr = featurize_ligand(mol, remove_hs=remove_hs)
    crystal_pos = heavy.pos.copy()
    matching_rmsd = 0.0
    if conformer_mode == "generate":
        from .conformers import generate_conformer

        gen = generate_conformer(heavy, seed=conformer_seed)
        # place the generated conformer at the crystal centroid so the
        # receptor-centered frame below stays sensible; randomize_position
        # re-draws the translation from the diffusion prior anyway
        heavy = heavy.replace_pos(gen - gen.mean(axis=0) + crystal_pos.mean(axis=0))
    elif conformer_mode == "match":
        from .conformers import conformer_match

        matched, matching_rmsd = conformer_match(
            heavy, crystal_pos, tries=matching_tries, popsize=matching_popsize,
            maxiter=matching_maxiter, seed=conformer_seed,
        )
        heavy = heavy.replace_pos(matched)
    elif conformer_mode != "input":
        raise ValueError(f"unknown conformer_mode {conformer_mode!r}")
    if chain_cutoff is not None:
        keep_chains = set()
        for r in structure.residues:
            if r.chain in keep_chains or "CA" not in r.atoms:
                continue
            # chain proximity is judged against the crystal pose (the input
            # coordinates), not a regenerated conformer
            d = np.linalg.norm(crystal_pos - r.atoms["CA"][None], axis=1).min()
            if d < chain_cutoff:
                keep_chains.add(r.chain)
        if keep_chains:
            structure = ProteinStructure([r for r in structure.residues if r.chain in keep_chains])
    tor_src, tor_dst, mask_rotate = get_transformation_mask(heavy.num_atoms, heavy.bonds)
    rec_f, rec_pos, rec_nbr, rec_nbr_mask, lm, residues = featurize_receptor(
        structure, lm_embeddings, c_alpha_max_neighbors, knn_only_graph, receptor_radius
    )
    center = rec_pos.mean(axis=0)
    atom_kwargs = {}
    if with_sidechains:
        from .parse_chi import side_chain_vecs

        atom_kwargs["rec_sidechain"] = side_chain_vecs(residues[: len(rec_f)])
    if all_atoms:
        atom_f, atom_pos, atom_nbr, atom_nbr_mask, atom_res = featurize_receptor_atoms(
            residues, atom_radius, atom_max_neighbors
        )
        atom_kwargs = dict(
            atom_f=atom_f,
            atom_pos=(atom_pos - center).astype(np.float32),
            atom_nbr=atom_nbr,
            atom_nbr_mask=atom_nbr_mask,
            atom_res=atom_res,
        )
    return HostComplex(
        name=name,
        lig_f=feats,
        lig_pos=(heavy.pos - center).astype(np.float32),
        lig_edge_src=esrc,
        lig_edge_dst=edst,
        lig_edge_attr=eattr,
        tor_src=tor_src,
        tor_dst=tor_dst,
        mask_rotate=mask_rotate,
        rec_f=rec_f,
        rec_lm=lm,
        rec_pos=(rec_pos - center).astype(np.float32),
        rec_nbr=rec_nbr,
        rec_nbr_mask=rec_nbr_mask,
        orig_center=center.astype(np.float32),
        # evaluation ground truth stays the input (crystal) pose even when
        # the starting geometry was regenerated/matched (reference keeps
        # orig_pos = crystal, process_mols.py:615-620)
        orig_lig_pos=(crystal_pos - center).astype(np.float32),
        matching_rmsd=float(matching_rmsd),
        **atom_kwargs,
    )
