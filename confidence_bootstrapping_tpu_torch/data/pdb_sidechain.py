"""PDB side-chain ("van der Mers") dataset: buried side chains as pseudo-ligands.

Port of ``confidence_bootstrapping_tpu/data/pdb_sidechain.py`` (the
reference's ``datasets/pdb.py``), part of the pretrained score model's
``triple_training`` recipe (``train --dataset generalisation``):

  * contact counting selects buried residues (reference :30-117, at least
    ``min_contacts`` residues with an atom within ``max_dist`` of the side
    chain), with scipy's ``cKDTree``;
  * the chosen residue's chemical group becomes the ligand, featurized from
    its Gly-X-Gly tripeptide SMILES (reference :120-145), or its side chain
    with bonds from per-amino-acid topology templates where atoms are
    missing; or, with ``add_random_ligand``, a random molecule of a SMILES
    list embedded at the side chain (reference :333-362);
  * a window of ``buffer_residue_num`` residues around it is deleted from
    the receptor (reference :274-331);
  * cluster splits from ``list.csv`` and cluster-random serving with
    ``multiplicity`` and ``merge_clusters`` (reference :249-260, :372-405).

The same structures, seeds and files give the same complexes as the JAX
package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from . import vocab
from .complex_graph import HostComplex
from .conformers import mol_from_smiles
from .featurize import featurize_ligand, featurize_receptor, get_transformation_mask
from .mol_io import Molecule, ProteinStructure, parse_pdb, parse_smiles

# side-chain bond topology per amino acid (heavy atoms beyond CA)
SIDECHAIN_BONDS: Dict[str, List[tuple]] = {
    "ALA": [("CA", "CB")],
    "ARG": [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "NE"), ("NE", "CZ"), ("CZ", "NH1"), ("CZ", "NH2")],
    "ASN": [("CA", "CB"), ("CB", "CG"), ("CG", "OD1"), ("CG", "ND2")],
    "ASP": [("CA", "CB"), ("CB", "CG"), ("CG", "OD1"), ("CG", "OD2")],
    "CYS": [("CA", "CB"), ("CB", "SG")],
    "GLN": [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "NE2")],
    "GLU": [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "OE2")],
    "HIS": [("CA", "CB"), ("CB", "CG"), ("CG", "ND1"), ("CG", "CD2"), ("ND1", "CE1"), ("CD2", "NE2"), ("CE1", "NE2")],
    "ILE": [("CA", "CB"), ("CB", "CG1"), ("CB", "CG2"), ("CG1", "CD1")],
    "LEU": [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2")],
    "LYS": [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "CE"), ("CE", "NZ")],
    "MET": [("CA", "CB"), ("CB", "CG"), ("CG", "SD"), ("SD", "CE")],
    "PHE": [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"), ("CD1", "CE1"), ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ")],
    "PRO": [("CA", "CB"), ("CB", "CG"), ("CG", "CD")],
    "SER": [("CA", "CB"), ("CB", "OG")],
    "THR": [("CA", "CB"), ("CB", "OG1"), ("CB", "CG2")],
    "TRP": [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"), ("CD1", "NE1"), ("NE1", "CE2"), ("CD2", "CE2"), ("CD2", "CE3"), ("CE2", "CZ2"), ("CE3", "CZ3"), ("CZ2", "CH2"), ("CZ3", "CH2")],
    "TYR": [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"), ("CD1", "CE1"), ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ"), ("CZ", "OH")],
    "VAL": [("CA", "CB"), ("CB", "CG1"), ("CB", "CG2")],
}
_AROMATIC = {"PHE": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
             "TYR": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
             "TRP": {"CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"},
             "HIS": {"CG", "ND1", "CD2", "CE1", "NE2"}}

# Gly-X-Gly tripeptide SMILES per amino acid + the heavy-atom SMILES index
# of each chemical-group atom (backbone N/CA/C/O + side chain). Chemical
# constants tables transcribed for feature parity (reference
# datasets/constants.py:102-147 amino_acid_smiles / cg_rdkit_indices).
AMINO_ACID_SMILES: Dict[str, str] = {
    "PHE": "[NH3+]CC(=O)N[C@@H](Cc1ccccc1)C(=O)NCC(=O)O",
    "MET": "CSCC[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "TYR": "[NH3+]CC(=O)N[C@@H](Cc1ccc(O)cc1)C(=O)NCC(=O)O",
    "ILE": "CC[C@H](C)[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "TRP": "[NH3+]CC(=O)N[C@@H](Cc1c[nH]c2ccccc12)C(=O)NCC(=O)O",
    "THR": "C[C@@H](O)[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "CYS": "[NH3+]CC(=O)N[C@@H](CS)C(=O)NCC(=O)O",
    "ALA": "C[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "LYS": "[NH3+]CCCC[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "PRO": "[NH3+]CC(=O)N1CCC[C@H]1C(=O)NCC(=O)O",
    "LEU": "CC(C)C[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "GLY": "[NH3+]CC(=O)NCC(=O)NCC(=O)O",
    "ASP": "[NH3+]CC(=O)N[C@@H](CC(=O)O)C(=O)NCC(=O)O",
    "HIS": "[NH3+]CC(=O)N[C@@H](Cc1c[nH]c[nH+]1)C(=O)NCC(=O)O",
    "VAL": "CC(C)[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "SER": "[NH3+]CC(=O)N[C@@H](CO)C(=O)NCC(=O)O",
    "ARG": "NC(=[NH2+])NCCC[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "GLU": "[NH3+]CC(=O)N[C@@H](CCC(=O)O)C(=O)NCC(=O)O",
    "GLN": "NC(=O)CC[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
    "ASN": "NC(=O)C[C@H](NC(=O)C[NH3+])C(=O)NCC(=O)O",
}
CG_SMILES_INDICES: Dict[str, Dict[int, str]] = {
    "PHE": {4: "N", 5: "CA", 13: "C", 14: "O", 6: "CB", 7: "CG", 8: "CD1", 12: "CD2", 9: "CE1", 11: "CE2", 10: "CZ"},
    "MET": {5: "N", 4: "CA", 10: "C", 11: "O", 3: "CB", 2: "CG", 1: "SD", 0: "CE"},
    "TYR": {4: "N", 5: "CA", 14: "C", 15: "O", 6: "CB", 7: "CG", 8: "CD1", 13: "CD2", 9: "CE1", 12: "CE2", 10: "CZ", 11: "OH"},
    "ILE": {5: "N", 4: "CA", 10: "C", 11: "O", 2: "CB", 1: "CG1", 3: "CG2", 0: "CD1"},
    "TRP": {4: "N", 5: "CA", 16: "C", 17: "O", 6: "CB", 7: "CG", 8: "CD1", 15: "CD2", 9: "NE1", 10: "CE2", 14: "CE3", 11: "CZ2", 13: "CZ3", 12: "CH2"},
    "THR": {4: "N", 3: "CA", 9: "C", 10: "O", 1: "CB", 2: "OG1", 0: "CG2"},
    "CYS": {4: "N", 5: "CA", 8: "C", 9: "O", 6: "CB", 7: "SG"},
    "ALA": {2: "N", 1: "CA", 7: "C", 8: "O", 0: "CB"},
    "LYS": {6: "N", 5: "CA", 11: "C", 12: "O", 4: "CB", 3: "CG", 2: "CD", 1: "CE", 0: "NZ"},
    "PRO": {4: "N", 8: "CA", 9: "C", 10: "O", 7: "CB", 6: "CG", 5: "CD"},
    "LEU": {5: "N", 4: "CA", 10: "C", 11: "O", 3: "CB", 1: "CG", 0: "CD1", 2: "CD2"},
    "GLY": {4: "N", 5: "CA", 6: "C", 7: "O"},
    "ASP": {4: "N", 5: "CA", 10: "C", 11: "O", 6: "CB", 7: "CG", 8: "OD1", 9: "OD2"},
    "HIS": {4: "N", 5: "CA", 12: "C", 13: "O", 6: "CB", 7: "CG", 11: "ND1", 8: "CD2", 10: "CE1", 9: "NE2"},
    "VAL": {4: "N", 3: "CA", 9: "C", 10: "O", 1: "CB", 0: "CG1", 2: "CG2"},
    "SER": {4: "N", 5: "CA", 8: "C", 9: "O", 6: "CB", 7: "OG"},
    "ARG": {8: "N", 7: "CA", 13: "C", 14: "O", 6: "CB", 5: "CG", 4: "CD", 3: "NE", 1: "CZ", 0: "NH1", 2: "NH2"},
    "GLU": {4: "N", 5: "CA", 11: "C", 12: "O", 6: "CB", 7: "CG", 8: "CD", 9: "OE1", 10: "OE2"},
    "GLN": {6: "N", 5: "CA", 11: "C", 12: "O", 4: "CB", 3: "CG", 1: "CD", 2: "OE1", 0: "NE2"},
    "ASN": {5: "N", 4: "CA", 10: "C", 11: "O", 3: "CB", 1: "CG", 2: "OD1", 0: "ND2"},
}

_CG_CACHE: Dict[str, Optional[tuple]] = {}


def compute_cg_features(aa: str):
    """Chemical-group graph for one amino acid from its Gly-X-Gly
    tripeptide SMILES (reference datasets/pdb.py:120-145): run the FULL
    ligand featurizer on the parsed tripeptide so the pseudo-ligand gets
    real chemistry features (aromaticity, hybridization, ring flags, ...),
    then subset to the group's atoms with relabeled bonds.

    -> (names, atomic_nums, charges, feats [n, 16], bonds) or None.
    """
    if aa in _CG_CACHE:
        return _CG_CACHE[aa]
    out = None
    mapping = CG_SMILES_INDICES.get(aa)
    if mapping:
        try:
            mol = parse_smiles(AMINO_ACID_SMILES[aa], name=aa)
            feats_all, heavy = featurize_ligand(mol)[:2]
            idxs = np.asarray(list(mapping.keys()))
            names = list(mapping.values())
            relabel = {int(si): k for k, si in enumerate(idxs)}
            bonds = [(relabel[i], relabel[j], o) for i, j, o in heavy.bonds
                     if i in relabel and j in relabel]
            out = (names, heavy.atomic_nums[idxs].copy(), heavy.charges[idxs].copy(),
                   feats_all[idxs].copy(), bonds)
        except Exception as e:  # parser edge case -> template fallback
            print(f"pdb_sidechain: cg features failed for {aa}: {type(e).__name__}: {e}")
    _CG_CACHE[aa] = out
    return out


def chemical_group_molecule(residue):
    """Residue -> (Molecule over the chemical-group atoms with real bond
    orders, full 16-slot feature rows), or (None, None) when the residue is
    missing atoms or has no chemical group."""
    cg = compute_cg_features(residue.name)
    if cg is None:
        return None, None
    names, nums, charges, feats, bonds = cg
    if not all(n in residue.atoms for n in names):
        return None, None
    pos = np.stack([residue.atoms[n] for n in names])
    mol = Molecule(nums.copy(), pos, list(bonds), charges.copy(),
                   name=f"{residue.chain}{residue.seq}{residue.name}")
    return mol, feats


def sidechain_molecule(residue) -> Optional[Molecule]:
    """Side chain (CA + beyond) of a residue as a Molecule, or None."""
    bonds_spec = SIDECHAIN_BONDS.get(residue.name)
    if not bonds_spec:
        return None
    names = ["CA"] + sorted({n for b in bonds_spec for n in b if n != "CA"})
    names = [n for n in names if n in residue.atoms]
    if len(names) < 3:
        return None
    index = {n: i for i, n in enumerate(names)}
    arom = _AROMATIC.get(residue.name, set())
    bonds = []
    for a, b in bonds_spec:
        if a in index and b in index:
            order = 4 if (a in arom and b in arom) else 1
            bonds.append((index[a], index[b], order))
    pos = np.stack([residue.atoms[n] for n in names])
    nums = np.asarray([residue.elements.get(n, 6) for n in names])
    return Molecule(nums, pos, bonds, np.zeros(len(names), dtype=int), name=f"{residue.chain}{residue.seq}{residue.name}")


def count_contacts(structure: ProteinStructure, max_dist: float = 5.0):
    """Per-residue count of distinct non-neighboring residues with any atom
    within max_dist of the residue's side-chain atoms (burial measure,
    reference datasets/pdb.py:30-117)."""
    all_pos, all_res = [], []
    for ri, r in enumerate(structure.residues):
        for name, xyz in r.atoms.items():
            all_pos.append(xyz)
            all_res.append(ri)
    all_pos = np.stack(all_pos)
    all_res = np.asarray(all_res)
    tree = cKDTree(all_pos)
    counts = np.zeros(len(structure.residues), dtype=int)
    backbone = {"N", "CA", "C", "O"}
    for ri, r in enumerate(structure.residues):
        side = [xyz for name, xyz in r.atoms.items() if name not in backbone]
        if not side:
            continue
        partners = set()
        for xyz in side:
            for k in tree.query_ball_point(xyz, max_dist):
                rj = all_res[k]
                if abs(rj - ri) > 1:
                    partners.add(rj)
        counts[ri] = len(partners)
    return counts


class PDBSidechainDataset:
    """Pseudo-ligand complexes from buried side chains of PDB structures."""

    def __init__(
        self,
        data_dir: str,
        cache_path: Optional[str] = None,
        min_contacts: int = 5,
        max_dist: float = 5.0,
        buffer_residue_num: int = 10,
        limit_structures: int = 0,
        max_complexes_per_structure: int = 5,
        seed: int = 0,
        c_alpha_max_neighbors: int = 24,
        split: Optional[str] = None,
        add_random_ligand: bool = False,
        smiles_list: Optional[Sequence[str]] = None,
        use_cg_features: bool = True,
        multiplicity: int = 1,
        merge_clusters: int = 1,
    ):
        """split: with a reference-style root layout (list.csv mapping
        CHAINID->CLUSTER plus valid_clusters.txt / test_clusters.txt,
        reference datasets/pdb.py:372-405), restrict structures to the
        given split's clusters (one chain per complex). add_random_ligand:
        replace the side-chain pseudo-ligand with a random molecule drawn
        from smiles_list, embedded in 3D and centered at the deleted
        window (reference :333-362)."""
        self.complexes: List[HostComplex] = []
        self.mols: Dict[str, Molecule] = {}
        rng = np.random.RandomState(seed)
        self.add_random_ligand = add_random_ligand
        self.use_cg_features = use_cg_features
        self.smiles_list = list(smiles_list) if smiles_list else []
        if add_random_ligand and not self.smiles_list:
            raise ValueError("add_random_ligand requires a smiles_list")
        files = sorted(f for f in os.listdir(data_dir) if f.endswith(".pdb"))
        if split is not None:
            keep = self._read_split(data_dir, split)
            files = [f for f in files if f[:4].lower() in keep or f[:-4].lower() in keep]
            print(f"pdb_sidechain split {split}: {len(files)} structures")
        if limit_structures:
            files = files[:limit_structures]
        for f in files:
            try:
                structure = parse_pdb(os.path.join(data_dir, f))
                contacts = count_contacts(structure, max_dist)
                candidates = [i for i, c in enumerate(contacts) if c >= min_contacts
                              and structure.residues[i].name in SIDECHAIN_BONDS]
                rng.shuffle(candidates)
                for i in candidates[:max_complexes_per_structure]:
                    hc = self._make_complex(structure, i, buffer_residue_num, f[:-4],
                                            c_alpha_max_neighbors, rng)
                    if hc is not None:
                        self.complexes.append(hc)
            except Exception as e:
                print(f"pdb_sidechain: skipping {f}: {type(e).__name__}: {e}")
        self.names = [hc.name for hc in self.complexes]
        self.by_name = {hc.name: hc for hc in self.complexes}

        # cluster-random serving (reference datasets/pdb.py:249-260): an
        # epoch visits len(clusters) * multiplicity // merge_clusters items;
        # each get() picks a cluster (merge_clusters adjacent clusters form
        # one slot) and serves a random complex of it. Clusters come from
        # list.csv when present, else one cluster per structure.
        self.multiplicity = int(multiplicity)
        self.merge_clusters = int(merge_clusters)
        chain_to_cluster = {}
        list_csv = os.path.join(data_dir, "list.csv")
        if os.path.exists(list_csv):
            import csv

            with open(list_csv) as f:
                for row in csv.DictReader(f):
                    chain_to_cluster[row["CHAINID"][:4].lower()] = row["CLUSTER"]
        self.cluster_to_names: Dict[str, List[str]] = {}
        for hc in self.complexes:
            cl = chain_to_cluster.get(hc.name[:4].lower(), hc.name.split("_")[0])
            self.cluster_to_names.setdefault(cl, []).append(hc.name)
        self.clusters = sorted(self.cluster_to_names)
        self._serve_rng = np.random.RandomState(seed + 1)

    @staticmethod
    def _read_split(root: str, split: str):
        """Cluster-based splits from list.csv + {valid,test}_clusters.txt
        (reference datasets/pdb.py:372-405); one chain per complex."""
        import csv

        rows = []
        with open(os.path.join(root, "list.csv")) as f:
            for row in csv.DictReader(f):
                rows.append((row["CHAINID"], row["CLUSTER"]))

        def read_clusters(name):
            p = os.path.join(root, name)
            return {line.strip() for line in open(p) if line.strip()} if os.path.exists(p) else set()

        val, test = read_clusters("valid_clusters.txt"), read_clusters("test_clusters.txt")
        if split == "train":
            wanted = {c for _, c in rows} - val - test
        elif split == "val":
            wanted = val
        elif split == "test":
            wanted = test
        else:
            raise ValueError("split must be train, val or test")
        keep, seen_complexes = set(), set()
        for chain, cluster in rows:
            if cluster in wanted and chain[:4] not in seen_complexes:
                keep.add(chain[:4].lower())
                keep.add(chain.lower())
                seen_complexes.add(chain[:4])
        return keep

    def _make_complex(self, structure, res_idx, buffer_n, struct_name, k, rng=None):
        residue = structure.residues[res_idx]
        if self.add_random_ligand:
            # random molecule from the SMILES list, embedded and placed at
            # the deleted side chain's location (reference pdb.py:333-362)
            mol = None
            rng = rng or np.random.RandomState(0)
            for _ in range(10):
                smiles = self.smiles_list[rng.randint(len(self.smiles_list))]
                try:
                    m = mol_from_smiles(smiles, seed=int(rng.randint(1 << 31))).remove_hs()
                    anchor = residue.atoms.get("CB", residue.atoms.get("CA"))
                    mol = m.replace_pos(m.pos - m.pos.mean(0) + anchor)
                    break
                except Exception as e:
                    print(f"pdb_sidechain: failed SMILES {smiles!r}: {e}")
            if mol is None:
                return None
            feats = featurize_ligand(mol, remove_hs=False)[0]
        else:
            # chemical-group graph from the tripeptide SMILES (reference
            # pdb.py:120-145); topology-template fallback for residues with
            # missing atoms
            mol, feats = (chemical_group_molecule(residue) if self.use_cg_features
                          else (None, None))
            if mol is None:
                mol = sidechain_molecule(residue)
                feats = None
        if mol is None:
            return None
        # delete a residue window around the pseudo-ligand (reference :274-331)
        keep = [r for j, r in enumerate(structure.residues) if abs(j - res_idx) > buffer_n]
        if len(keep) < 16:
            return None
        sub = ProteinStructure(keep)
        rec_f, rec_pos, rec_nbr, rec_nbr_mask, lm, _ = featurize_receptor(sub, c_alpha_max_neighbors=k)
        center = rec_pos.mean(axis=0)

        n = mol.num_atoms
        if feats is None:
            feats = np.zeros((n, 16), dtype=np.int64)
            for i in range(n):
                feats[i, 0] = vocab.safe_index(vocab.ATOMIC_NUMS, int(mol.atomic_nums[i]))
        src, dst, attr = [], [], []
        onehot = {1: 0, 2: 1, 3: 2, 4: 3}
        for i, j, o in mol.bonds:
            for a, b in ((i, j), (j, i)):
                src.append(a)
                dst.append(b)
                v = np.zeros(4, dtype=np.float32)
                v[onehot.get(o, 0)] = 1
                attr.append(v)
        tor_src, tor_dst, mask_rotate = get_transformation_mask(n, mol.bonds)
        name = f"{struct_name}_{mol.name}"
        self.mols[name] = mol
        return HostComplex(
            name=name,
            lig_f=feats,
            lig_pos=(mol.pos - center).astype(np.float32),
            lig_edge_src=np.asarray(src, dtype=np.int32),
            lig_edge_dst=np.asarray(dst, dtype=np.int32),
            lig_edge_attr=np.asarray(attr, dtype=np.float32).reshape(-1, 4),
            tor_src=tor_src,
            tor_dst=tor_dst,
            mask_rotate=mask_rotate,
            rec_f=rec_f,
            rec_lm=lm,
            rec_pos=(rec_pos - center).astype(np.float32),
            rec_nbr=rec_nbr,
            rec_nbr_mask=rec_nbr_mask,
            orig_center=center.astype(np.float32),
            orig_lig_pos=(mol.pos - center).astype(np.float32),
        )

    def __len__(self):
        if not self.clusters:
            return 0
        return max(1, len(self.clusters) * self.multiplicity // self.merge_clusters)

    def get(self, idx: int):
        """Cluster-random item (reference datasets/pdb.py:251-260): idx maps
        to a cluster slot; with merge_clusters > 1 one of the merged
        adjacent clusters is drawn at random, then a random complex of it."""
        if self.multiplicity == 1 and self.merge_clusters == 1 and len(self.clusters) == len(self.complexes):
            return self.complexes[idx % len(self.complexes)]
        ci = idx % len(self.clusters)
        if self.merge_clusters > 1:
            ci = min(ci * self.merge_clusters + self._serve_rng.randint(self.merge_clusters),
                     len(self.clusters) - 1)
        names = self.cluster_to_names[self.clusters[ci]]
        return self.by_name[names[self._serve_rng.randint(len(names))]]

    def get_by_name(self, name: str):
        return self.by_name[name]
