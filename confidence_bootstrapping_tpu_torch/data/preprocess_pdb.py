"""Binding MOAD / PDB download and preprocessing helpers.

Port of ``confidence_bootstrapping_tpu/data/preprocess_pdb.py`` (the
reference's ``data/preprocess_PDB.py`` and ``data/http_requests.py``):
standalone data preparation that turns raw PDB biounits into the
per-complex trees the dataset layer reads. The MOAD ligand blacklist (the
port's copy of the JSON asset), hetero-ligand extraction with
distance-inferred bonds, bond orders and charges from a SMILES template,
biounit splitting, and the download helpers (``download_pdb``,
``fetch_component_smiles``; they need network access and return None
without it).

The template match is an element-labelled graph isomorphism written here
(colour refinement of both graphs together, then backtracking in
breadth-first order), where the JAX package uses networkx's VF2 matcher.
Where a molecule has several equal mappings (symmetric atoms), the two may
pick different ones: the bond orders and charges then land on symmetric
atoms of the other choice.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..eval.rmsd import _adjacency, _refined_colours, _search_order
from .mol_io import Molecule, atomic_number, parse_smiles, write_sdf


def load_moad_blacklist() -> frozenset:
    """The full Binding MOAD ligand blacklist (1554 entries of cofactor /
    ion / buffer / peptide ligand name strings) — a data constant that must
    match the reference byte-for-byte for dataset parity (reference
    data/preprocess_PDB.py:1-337 ``black_list``); shipped as a JSON asset."""
    p = os.path.join(os.path.dirname(__file__), "moad_ligand_blacklist.json")
    with open(p) as f:
        return frozenset(json.load(f))


# Short built-in subset used by the hetero-ligand extractor for single-name
# lookups (the full MOAD table above also covers multi-component names like
# "ACT CD"; extract_hetero_ligands sees one residue name at a time).
LIGAND_BLACKLIST = {
    "HOH", "DOD", "WAT", "SO4", "PO4", "GOL", "EDO", "PEG", "PGE", "ACT",
    "DMS", "TRS", "MES", "EPE", "FMT", "CIT", "TAR", "MLI", "ACE", "NH2",
    "NA", "CL", "K", "MG", "CA", "ZN", "MN", "FE", "FE2", "CU", "NI", "CO",
    "CD", "HG", "BR", "IOD", "F", "CS", "LI", "SR", "BA", "NO3", "NH4",
    "CO3", "BCT", "OH", "O2", "CMO", "SCN", "AZI", "BME", "MPD", "IPA",
    "MOH", "EOH", "POP", "PG4", "1PE", "P6G", "DTT", "IMD", "CAC",
}

RCSB_BIOUNIT_URL = "https://files.rcsb.org/download/{pdb_id}.pdb1.gz"
BINDING_MOAD_URL = "https://www.bindingmoad.org/files/biou/every_part_a.zip"


def download_pdb(pdb_id: str, out_dir: str, url_template: str = RCSB_BIOUNIT_URL) -> Optional[str]:
    """Download a biounit PDB (requires network; gated)."""
    try:
        import gzip
        import urllib.request

        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"{pdb_id}.pdb")
        if os.path.exists(out):
            return out
        with urllib.request.urlopen(url_template.format(pdb_id=pdb_id), timeout=60) as r:
            data = r.read()
        if url_template.endswith(".gz"):
            data = gzip.decompress(data)
        with open(out, "wb") as f:
            f.write(data)
        return out
    except Exception as e:
        print(f"download failed for {pdb_id}: {type(e).__name__}: {e}")
        return None


def extract_hetero_ligands(pdb_path: str, min_atoms: int = 3, max_atoms: int = 200,
                           blacklist=None) -> List[Tuple[str, Molecule]]:
    """HETATM groups -> candidate ligand Molecules (blacklist-filtered).

    Bonds are inferred by distance (covalent radii heuristic) since PDB
    HETATM records carry no bond table. blacklist defaults to the built-in
    short table plus the reference's full 1554-entry MOAD list.
    """
    if blacklist is None:
        blacklist = LIGAND_BLACKLIST | load_moad_blacklist()
    groups: Dict[Tuple[str, str, int], List[Tuple[str, int, np.ndarray]]] = {}
    for line in open(pdb_path):
        if not line.startswith("HETATM"):
            continue
        resname = line[17:20].strip()
        if resname in blacklist:
            continue
        chain = line[21]
        try:
            seq = int(line[22:26])
        except ValueError:
            continue
        name = line[12:16].strip()
        el = line[76:78].strip() if len(line) > 77 else name[0]
        xyz = np.asarray([float(line[30:38]), float(line[38:46]), float(line[46:54])])
        groups.setdefault((resname, chain, seq), []).append((name, atomic_number(el), xyz))

    out = []
    for (resname, chain, seq), atoms in groups.items():
        heavy = [(n, z, p) for n, z, p in atoms if z > 1]
        if not (min_atoms <= len(heavy) <= max_atoms):
            continue
        pos = np.stack([p for _, _, p in heavy])
        nums = np.asarray([z for _, z, _ in heavy])
        bonds = infer_bonds(pos, nums)
        out.append((f"{resname}_{chain}{seq}", Molecule(nums, pos, bonds, np.zeros(len(nums), dtype=int), resname)))
    return out


_COV_RADII = {1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11, 15: 1.07, 16: 1.05, 17: 1.02, 35: 1.2, 53: 1.39}


def infer_bonds(pos: np.ndarray, nums: np.ndarray, tol: float = 0.45) -> List[Tuple[int, int, int]]:
    """Distance-based covalent bond inference (single bonds)."""
    n = len(pos)
    bonds = []
    for i in range(n):
        for j in range(i + 1, n):
            rmax = _COV_RADII.get(int(nums[i]), 1.2) + _COV_RADII.get(int(nums[j]), 1.2) + tol
            if np.linalg.norm(pos[i] - pos[j]) < rmax:
                bonds.append((i, j, 1))
    return bonds


def fetch_component_smiles(chem_id: str) -> Optional[str]:
    """SMILES of a PDB chemical component from the RCSB REST API
    (reference data/preprocess_PDB.py:358-396 ``describe_chemical``;
    network-gated — returns None without egress)."""
    try:
        import urllib.request

        url = f"https://data.rcsb.org/rest/v1/core/chemcomp/{chem_id.upper()}"
        with urllib.request.urlopen(url, timeout=30) as r:
            data = json.loads(r.read())
        descr = data.get("rcsb_chem_comp_descriptor", {})
        return descr.get("smiles") or descr.get("smilesstereo")
    except Exception as e:
        print(f"chemcomp lookup failed for {chem_id}: {type(e).__name__}: {e}")
        return None


def element_isomorphism(z1, bonds1, z2, bonds2) -> Optional[Dict[int, int]]:
    """A mapping {atom of graph 1: atom of graph 2} that keeps every
    element and every bond (bond orders ignored), or None when the graphs
    are not isomorphic. Both graphs are coloured together by colour
    refinement from the elements; atoms are then mapped in breadth-first
    order of graph 1, each to an unused atom of its own colour whose mapped
    neighbours are exactly the images of its own."""
    n = len(z1)
    if n != len(z2) or len({(min(i, j), max(i, j)) for i, j, _ in bonds1}) != len(
            {(min(i, j), max(i, j)) for i, j, _ in bonds2}):
        return None
    adj1, adj2 = _adjacency(n, bonds1), _adjacency(n, bonds2)
    colours = _refined_colours(list(z1) + list(z2), adj1 + [{j + n for j in a} for a in adj2])
    c1, c2 = colours[:n], colours[n:]
    if sorted(c1) != sorted(c2):
        return None
    by_colour: Dict[int, List[int]] = {}
    for v, c in enumerate(c2):
        by_colour.setdefault(c, []).append(v)
    order = _search_order(adj1)
    image, used = [-1] * n, [False] * n

    def fits(i: int, v: int) -> bool:
        mapped = [image[u] for u in adj1[i] if image[u] >= 0]
        return all(w in adj2[v] for w in mapped) and sum(1 for w in adj2[v] if used[w]) == len(mapped)

    def extend(depth: int) -> bool:
        if depth == n:
            return True
        i = order[depth]
        for v in by_colour.get(c1[i], []):
            if not used[v] and fits(i, v):
                image[i], used[v] = v, True
                if extend(depth + 1):
                    return True
                image[i], used[v] = -1, False
        return False

    return {i: image[i] for i in range(n)} if extend(0) else None


def assign_bond_orders_from_template(template: Molecule, mol: Molecule) -> Optional[Molecule]:
    """Transfer bond orders + formal charges from a SMILES-derived template
    onto a coordinate molecule with distance-inferred single bonds (the
    reference's rdkit ``AssignBondOrdersFromTemplate`` step,
    data/preprocess_PDB.py:410-462 ``process_ligand``): the template's heavy
    atoms matched to the molecule's by ``element_isomorphism``. Returns None
    when the template does not match (the caller keeps the inferred single
    bonds)."""
    t = template.remove_hs()
    mapping = element_isomorphism(t.atomic_nums, t.bonds, mol.atomic_nums, mol.bonds)
    if mapping is None:
        return None
    bonds = [(mapping[i], mapping[j], o) for i, j, o in t.bonds]
    charges = np.zeros(mol.num_atoms, dtype=int)
    for ti, mi in mapping.items():
        charges[mi] = int(t.charges[ti])
    return Molecule(mol.atomic_nums, mol.pos, bonds, charges, mol.name)


def apply_smiles_templates(ligands, smiles_lookup) -> List[Tuple[str, Molecule]]:
    """Upgrade extracted ligands with component-dictionary bond orders.

    smiles_lookup: {resname: smiles} dict or a callable (e.g.
    fetch_component_smiles). Ligands whose template is missing or does not
    match keep their inferred single bonds."""
    out = []
    for lig_name, mol in ligands:
        smi = smiles_lookup(mol.name) if callable(smiles_lookup) else smiles_lookup.get(mol.name)
        fixed = None
        if smi:
            try:
                fixed = assign_bond_orders_from_template(parse_smiles(smi, name=mol.name), mol)
            except Exception as e:
                print(f"template assignment failed for {mol.name}: {type(e).__name__}: {e}")
        out.append((lig_name, fixed if fixed is not None else mol))
    return out


def split_biounit(pdb_path: str, out_dir: str, name: Optional[str] = None,
                  smiles_lookup=None) -> List[str]:
    """One biounit PDB -> DockGen-style per-complex trees
    ``{name}_{lig}/..._protein_processed.pdb + ..._ligand.sdf``."""
    name = name or os.path.splitext(os.path.basename(pdb_path))[0]
    ligands = extract_hetero_ligands(pdb_path)
    if smiles_lookup is not None:
        ligands = apply_smiles_templates(ligands, smiles_lookup)
    if not ligands:
        return []
    protein_text = "".join(l for l in open(pdb_path) if l.startswith(("ATOM  ", "TER", "END")))
    made = []
    for lig_name, mol in ligands:
        cname = f"{name}_{lig_name}"
        d = os.path.join(out_dir, cname)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{cname}_protein_processed.pdb"), "w") as f:
            f.write(protein_text)
        write_sdf(mol, mol.pos, os.path.join(d, f"{cname}_ligand.sdf"), name=cname)
        made.append(cname)
    return made
