"""Molecule and protein file IO without RDKit, BioPython or ProDy.

Port of ``confidence_bootstrapping_tpu/data/mol_io.py`` (host numpy code,
copied so that the port imports nothing of the JAX package): SDF (V2000),
MOL2 and PDB readers, the repository's own SMILES parser, and the writers of
ranked SDF poses and multi-MODEL PDB trajectories. ``Molecule`` is the one
molecule class of the port (``data.complex_graph`` re-exports it). The SDF
writer's header line names the JAX package, so that both packages write the
same bytes.
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# default valences for implicit-H estimation (organic subset)
_DEFAULT_VALENCE = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 5, 16: 6, 17: 1, 35: 1, 53: 1}

_SYMBOLS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Ne": 10,
    "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16, "Cl": 17, "Ar": 18, "K": 19,
    "Ca": 20, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30, "As": 33, "Se": 34,
    "Br": 35, "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "I": 53, "Pt": 78, "Au": 79, "Hg": 80,
}
_NUM_TO_SYMBOL = {v: k for k, v in _SYMBOLS.items()}


def atomic_number(symbol: str) -> int:
    s = symbol.strip()
    if not s:
        return 0
    s = s[0].upper() + s[1:].lower()
    return _SYMBOLS.get(s, 0)


@dataclass
class Molecule:
    """Minimal in-memory molecule: atoms, 3D coords, bonds with orders.

    bond order 4 encodes 'aromatic' (SDF/MOL2 convention).
    """

    atomic_nums: np.ndarray  # [n] int
    pos: np.ndarray  # [n, 3] float
    bonds: List[Tuple[int, int, int]]  # (i, j, order)
    charges: np.ndarray  # [n] int formal charges
    name: str = ""

    @property
    def num_atoms(self):
        return len(self.atomic_nums)

    def heavy_indices(self):
        return np.nonzero(self.atomic_nums != 1)[0]

    def replace_pos(self, pos: np.ndarray) -> "Molecule":
        """Same topology with new coordinates (conformer swap)."""
        assert pos.shape == self.pos.shape, (pos.shape, self.pos.shape)
        return Molecule(self.atomic_nums, np.asarray(pos, dtype=self.pos.dtype), self.bonds, self.charges, self.name)

    def remove_hs(self) -> "Molecule":
        """Heavy-atom submolecule; explicit H counts retrievable via bonds."""
        keep = self.heavy_indices()
        remap = -np.ones(self.num_atoms, dtype=int)
        remap[keep] = np.arange(len(keep))
        bonds = [
            (int(remap[i]), int(remap[j]), o)
            for i, j, o in self.bonds
            if remap[i] >= 0 and remap[j] >= 0
        ]
        return Molecule(self.atomic_nums[keep], self.pos[keep], bonds, self.charges[keep], self.name)

    def explicit_h_counts(self) -> np.ndarray:
        """Number of explicit hydrogens attached to each atom (this mol)."""
        h = np.zeros(self.num_atoms, dtype=int)
        for i, j, _ in self.bonds:
            if self.atomic_nums[j] == 1:
                h[i] += 1
            if self.atomic_nums[i] == 1:
                h[j] += 1
        return h


def parse_sdf(path_or_text: str, is_text: bool = False) -> Molecule:
    """Parse the first molecule of an SDF/MOL V2000 file."""
    text = path_or_text if is_text else open(path_or_text).read()
    lines = text.splitlines()
    name = lines[0].strip() if lines else ""
    counts = lines[3]
    na, nb = int(counts[0:3]), int(counts[3:6])
    pos = np.zeros((na, 3))
    nums = np.zeros(na, dtype=int)
    charges = np.zeros(na, dtype=int)
    for i in range(na):
        l = lines[4 + i]
        pos[i] = [float(l[0:10]), float(l[10:20]), float(l[20:30])]
        nums[i] = atomic_number(l[31:34])
        # old-style charge column (4 = 0; 3=+1.. per spec: chg = 4 - col)
        try:
            cc = int(l[36:39])
            if cc != 0:
                charges[i] = 4 - cc
        except (ValueError, IndexError):
            pass
    bonds = []
    for k in range(nb):
        l = lines[4 + na + k]
        i, j, o = int(l[0:3]) - 1, int(l[3:6]) - 1, int(l[6:9])
        bonds.append((i, j, o))
    for l in lines[4 + na + nb :]:
        if l.startswith("M  CHG"):
            parts = l.split()
            n = int(parts[2])
            for k in range(n):
                charges[int(parts[3 + 2 * k]) - 1] = int(parts[4 + 2 * k])
        if l.startswith("M  END") or l.startswith("$$$$"):
            break
    return Molecule(nums, pos, bonds, charges, name)


_MOL2_BOND = {"1": 1, "2": 2, "3": 3, "ar": 4, "am": 1, "du": 1, "un": 1, "nc": 0}


def parse_mol2(path: str) -> Molecule:
    lines = open(path).read().splitlines()
    section = None
    atoms, bonds, charges = [], [], []
    name = ""
    for l in lines:
        if l.startswith("@<TRIPOS>"):
            section = l[9:].strip().lower()
            continue
        if not l.strip():
            continue
        if section == "molecule" and not name:
            name = l.strip()
        elif section == "atom":
            p = l.split()
            sym = p[5].split(".")[0]
            atoms.append((atomic_number(sym), float(p[2]), float(p[3]), float(p[4])))
            charges.append(int(round(float(p[8]))) if len(p) > 8 else 0)
        elif section == "bond":
            p = l.split()
            o = _MOL2_BOND.get(p[3].lower(), 1)
            if o:
                bonds.append((int(p[1]) - 1, int(p[2]) - 1, o))
    nums = np.asarray([a[0] for a in atoms], dtype=int)
    pos = np.asarray([[a[1], a[2], a[3]] for a in atoms])
    return Molecule(nums, pos, bonds, np.asarray(charges, dtype=int), name)


def read_molecule(path: str) -> Molecule:
    if path.endswith(".sdf") or path.endswith(".mol"):
        return parse_sdf(path)
    if path.endswith(".mol2"):
        return parse_mol2(path)
    raise ValueError(f"unsupported ligand format: {path}")


_ORGANIC_SUBSET = {"B": 5, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16, "F": 9, "Cl": 17, "Br": 35, "I": 53}
_SYMBOL_TO_NUM = {"H": 1, "He": 2, "Li": 3, "Be": 4, "Na": 11, "Mg": 12, "Al": 13, "Si": 14,
                  "K": 19, "Ca": 20, "Fe": 26, "Zn": 30, "Se": 34, "As": 33, **_ORGANIC_SUBSET}
_DEFAULT_VALENCE = {5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 15: 3, 16: 2, 17: 1, 35: 1, 53: 1}


def parse_smiles(smiles: str, add_hs: bool = True, name: str = "") -> Molecule:
    """Minimal RDKit-free SMILES parser -> Molecule (no 3D coordinates; use
    ``conformers.embed_molecule`` to generate them).

    Mirrors the subset the reference needs from RDKit's MolFromSmiles
    (dock.py SMILES ligands, datasets/pdb.py random-ligand attachment):
    organic-subset atoms, bracket atoms with charge/H-count, branches, ring
    closures (incl. %nn), bond orders -/=/#/:, aromatic lowercase atoms
    (aromatic bonds become order 4), dots rejected. Stereo markers (/\\@)
    are accepted and ignored (docking randomizes torsions anyway). With
    add_hs, implicit hydrogens (standard valences; aromatic bonds count
    1.5) are added as explicit H atoms at position 0 so featurization's
    explicit-H counting matches the reference AddHs protocol.
    """
    nums: List[int] = []
    charges: List[int] = []
    aromatic: List[bool] = []
    explicit_h: List[int] = []  # bracket-specified H counts (-1 = implicit)
    bonds: List[Tuple[int, int, int]] = []

    prev_stack: List[Optional[int]] = []
    prev: Optional[int] = None
    pending_bond: Optional[int] = None
    ring: Dict[int, Tuple[int, Optional[int]]] = {}

    def add_atom(z: int, arom: bool, charge: int = 0, h: int = -1) -> int:
        nums.append(z)
        charges.append(charge)
        aromatic.append(arom)
        explicit_h.append(h)
        return len(nums) - 1

    def close_bond(a: int, b: int, order: Optional[int]):
        if order is None:
            order = 4 if (aromatic[a] and aromatic[b]) else 1
        bonds.append((a, b, order))

    i, n = 0, len(smiles)
    bond_chars = {"-": 1, "=": 2, "#": 3, ":": 4, "/": 1, "\\": 1}
    while i < n:
        ch = smiles[i]
        if ch in bond_chars:
            pending_bond = bond_chars[ch]
            i += 1
        elif ch == "(":
            prev_stack.append(prev)
            i += 1
        elif ch == ")":
            prev = prev_stack.pop()
            i += 1
        elif ch == ".":
            raise ValueError("disconnected SMILES fragments are not supported")
        elif ch == "[":
            j = smiles.index("]", i)
            body = smiles[i + 1 : j]
            k = 0
            while k < len(body) and body[k].isdigit():  # isotope, ignored
                k += 1
            sym = body[k]
            if k + 1 < len(body) and body[k + 1].islower() and body[k : k + 2] in _SYMBOL_TO_NUM:
                sym = body[k : k + 2]
                k += 2
            else:
                k += 1
            arom = sym.islower()
            z = _SYMBOL_TO_NUM.get(sym.capitalize())
            if z is None:
                raise ValueError(f"unknown element {sym!r} in SMILES")
            h, charge = 0, 0
            while k < len(body):
                c = body[k]
                if c == "H":
                    k += 1
                    cnt = ""
                    while k < len(body) and body[k].isdigit():
                        cnt += body[k]
                        k += 1
                    h = int(cnt) if cnt else 1
                elif c in "+-":
                    sgn = 1 if c == "+" else -1
                    k += 1
                    cnt = ""
                    while k < len(body) and body[k].isdigit():
                        cnt += body[k]
                        k += 1
                    if cnt:
                        charge += sgn * int(cnt)
                    else:
                        charge += sgn
                        while k < len(body) and body[k] == c:  # ++ / --
                            charge += sgn
                            k += 1
                else:  # stereo (@), class (:n) — ignored
                    k += 1
            a = add_atom(z, arom, charge, h)
            if prev is not None:
                close_bond(prev, a, pending_bond)
            prev, pending_bond = a, None
            i = j + 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                num = int(smiles[i + 1 : i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if num in ring:
                a, order = ring.pop(num)
                close_bond(a, prev, pending_bond if pending_bond is not None else order)
            else:
                ring[num] = (prev, pending_bond)
            pending_bond = None
        else:
            sym = ch
            if i + 1 < n and smiles[i : i + 2] in ("Cl", "Br"):
                sym = smiles[i : i + 2]
                i += 2
            else:
                i += 1
            arom = sym.islower()
            z = _ORGANIC_SUBSET.get(sym.capitalize() if arom else sym)
            if z is None:
                raise ValueError(f"unexpected SMILES token {sym!r}")
            a = add_atom(z, arom, 0, -1)
            if prev is not None:
                close_bond(prev, a, pending_bond)
            prev, pending_bond = a, None
    if ring:
        raise ValueError(f"unclosed SMILES ring bond(s): {sorted(ring)}")

    if add_hs:
        n_heavy = len(nums)
        order_sum = [0.0] * n_heavy
        for a, b, o in bonds:
            v = 1.5 if o == 4 else float(o)
            order_sum[a] += v
            order_sum[b] += v
        for a in range(n_heavy):
            if explicit_h[a] >= 0:
                h = explicit_h[a]
            else:
                val = _DEFAULT_VALENCE.get(nums[a], 0) + (charges[a] if nums[a] in (7, 15) else -abs(charges[a]))
                h = max(0, int(np.floor(val - order_sum[a] + 1e-6)))
            for _ in range(h):
                nums.append(1)
                charges.append(0)
                bonds.append((a, len(nums) - 1, 1))

    pos = np.zeros((len(nums), 3), dtype=np.float32)
    return Molecule(np.asarray(nums), pos, bonds, np.asarray(charges, dtype=int), name or smiles)


def write_sdf(mol: Molecule, pos: np.ndarray, path: str, name: Optional[str] = None, props: Optional[Dict] = None):
    """Write a V2000 SDF with the given coordinates."""
    n, nb = mol.num_atoms, len(mol.bonds)
    out = [name or mol.name or "ligand", "  generated by confidence_bootstrapping_tpu", ""]
    out.append(f"{n:3d}{nb:3d}  0  0  0  0  0  0  0  0999 V2000")
    for i in range(n):
        sym = _NUM_TO_SYMBOL.get(int(mol.atomic_nums[i]), "C")
        out.append(f"{pos[i,0]:10.4f}{pos[i,1]:10.4f}{pos[i,2]:10.4f} {sym:<3s} 0  0  0  0  0")
    for i, j, o in mol.bonds:
        out.append(f"{i+1:3d}{j+1:3d}{min(o,4):3d}  0")
    chg = [(i, c) for i, c in enumerate(mol.charges) if c]
    for k in range(0, len(chg), 8):
        grp = chg[k : k + 8]
        out.append("M  CHG" + f"{len(grp):3d}" + "".join(f"{i+1:4d}{c:4d}" for i, c in grp))
    out.append("M  END")
    if props:
        for k, v in props.items():
            out.append(f"> <{k}>")
            out.append(str(v))
            out.append("")
    out.append("$$$$")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


@dataclass
class Residue:
    name: str
    chain: str
    seq: int
    icode: str
    atoms: Dict[str, np.ndarray] = field(default_factory=dict)  # atom name -> xyz
    elements: Dict[str, int] = field(default_factory=dict)  # atom name -> Z


@dataclass
class ProteinStructure:
    residues: List[Residue]
    name: str = ""

    def chains(self):
        out = {}
        for r in self.residues:
            out.setdefault(r.chain, []).append(r)
        return out

    def sequence(self, chain=None) -> str:
        from .vocab import AMINO_ACIDS

        three_to_one = {
            "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q", "GLU": "E",
            "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F",
            "PRO": "P", "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
        }
        rs = self.residues if chain is None else [r for r in self.residues if r.chain == chain]
        return "".join(three_to_one.get(r.name, "X") for r in rs)


def parse_pdb(path: str, model: int = 1) -> ProteinStructure:
    """Parse ATOM records of a PDB file into residues (first altloc wins)."""
    residues: List[Residue] = []
    index: Dict[Tuple[str, int, str], Residue] = {}
    current_model = 1
    for line in open(path):
        rec = line[0:6]
        if rec == "MODEL ":
            current_model = int(line.split()[1])
        elif rec == "ENDMDL":
            if current_model == model:
                break
        elif rec == "ATOM  " and current_model == model:
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            name = line[12:16].strip()
            resname = line[17:20].strip()
            chain = line[21]
            try:
                seq = int(line[22:26])
            except ValueError:
                continue
            icode = line[26]
            key = (chain, seq, icode)
            if key not in index:
                r = Residue(resname, chain, seq, icode)
                index[key] = r
                residues.append(r)
            r = index[key]
            if name not in r.atoms:
                xyz = np.asarray([float(line[30:38]), float(line[38:46]), float(line[46:54])])
                r.atoms[name] = xyz
                el = line[76:78].strip() if len(line) > 77 else ""
                r.elements[name] = atomic_number(el) if el else atomic_number(name[0])
    return ProteinStructure(residues)


def write_pdb_trajectory(mol: Molecule, trajectory: np.ndarray, path: str):
    """Multi-MODEL PDB of a ligand trajectory (reference utils/visualise.py)."""
    lines = []
    for m, pos in enumerate(trajectory):
        lines.append(f"MODEL     {m+1:4d}")
        for i in range(mol.num_atoms):
            sym = _NUM_TO_SYMBOL.get(int(mol.atomic_nums[i]), "C")
            lines.append(
                f"HETATM{i+1:5d} {sym:<4s}LIG A   1    "
                f"{pos[i,0]:8.3f}{pos[i,1]:8.3f}{pos[i,2]:8.3f}  1.00  0.00          {sym:>2s}"
            )
        for i, j, _ in mol.bonds:
            lines.append(f"CONECT{i+1:5d}{j+1:5d}")
        lines.append("ENDMDL")
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
