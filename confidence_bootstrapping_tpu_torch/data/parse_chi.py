"""Side-chain chi angles and backbone vectors of receptor residues.

Port of ``confidence_bootstrapping_tpu/data/parse_chi.py`` (host numpy):
per residue, chi1-4 normalized to [0, 1) (NaN where undefined) and the CA->N
and CA->C unit vectors; ``featurize.build_host_complex(with_sidechains=True)``
stores them as ``rec_sidechain``.
"""


from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# chi dihedral atom quadruples per amino acid (standard rotamer definitions)
CHI_ATOMS: Dict[str, List[Tuple[str, str, str, str]]] = {
    "ARG": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"), ("CB", "CG", "CD", "NE"), ("CG", "CD", "NE", "CZ")],
    "ASN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "ASP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "CYS": [("N", "CA", "CB", "SG")],
    "GLN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"), ("CB", "CG", "CD", "OE1")],
    "GLU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"), ("CB", "CG", "CD", "OE1")],
    "HIS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "ND1")],
    "ILE": [("N", "CA", "CB", "CG1"), ("CA", "CB", "CG1", "CD1")],
    "LEU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "LYS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"), ("CB", "CG", "CD", "CE"), ("CG", "CD", "CE", "NZ")],
    "MET": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "SD"), ("CB", "CG", "SD", "CE")],
    "PHE": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "PRO": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD")],
    "SER": [("N", "CA", "CB", "OG")],
    "THR": [("N", "CA", "CB", "OG1")],
    "TRP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "TYR": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "VAL": [("N", "CA", "CB", "CG1")],
}


def dihedral(p0, p1, p2, p3) -> float:
    """Signed dihedral angle in radians (IUPAC convention)."""
    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2
    b1 = b1 / (np.linalg.norm(b1) + 1e-12)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    x = np.dot(v, w)
    y = np.dot(np.cross(b1, v), w)
    return float(np.arctan2(y, x))


def residue_chi_angles(residue) -> np.ndarray:
    """chi1-4 normalized to [0, 1); NaN where the angle is undefined."""
    out = np.full(4, np.nan, dtype=np.float32)
    specs = CHI_ATOMS.get(residue.name, [])
    for i, (a, b, c, d) in enumerate(specs[:4]):
        if all(n in residue.atoms for n in (a, b, c, d)):
            ang = dihedral(residue.atoms[a], residue.atoms[b], residue.atoms[c], residue.atoms[d])
            out[i] = (ang / (2 * np.pi)) % 1.0
    return out


def residue_backbone_vecs(residue) -> np.ndarray:
    """[2, 3] unit vectors CA->N and CA->C (NaN-free; zeros if missing)."""
    out = np.zeros((2, 3), dtype=np.float32)
    ca = residue.atoms.get("CA")
    if ca is None:
        return out
    for i, name in enumerate(("N", "C")):
        a = residue.atoms.get(name)
        if a is not None:
            v = a - ca
            n = np.linalg.norm(v)
            if n > 1e-6:
                out[i] = v / n
    return out


def side_chain_vecs(residues) -> np.ndarray:
    """[n, 10]: chi1-4 (normalized, NaN if undefined) + flattened backbone
    unit vectors — the score model's side-chain regression targets."""
    out = np.zeros((len(residues), 10), dtype=np.float32)
    for i, r in enumerate(residues):
        out[i, :4] = residue_chi_angles(r)
        out[i, 4:] = residue_backbone_vecs(r).reshape(-1)
    return out
