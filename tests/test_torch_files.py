"""Seeded synthetic PDB and SDF files for the port's host-layer and CLI tests,
written the way the JAX package's tests write theirs
(tests/test_datasets.py:72-95, tests/test_host_utils.py:250), and the
checks that the port's readers take them back. Imports no JAX, so the card's
test (tests/test_torch_kernels_cuda.py) can use them too."""

from __future__ import annotations

import os

import numpy as np

from confidence_bootstrapping_tpu_torch.data import mol_io
from confidence_bootstrapping_tpu_torch.data.conformers import mol_from_smiles

# a ring system, an amide, an ether ring, a charged amine: aromatic bonds, rings of 5 and 6, rotatable bonds
SMILES = "C[NH+](C)CCc1ccc(cc1)C(=O)NCc1ccc2OCOc2c1"
BACKBONE = {"N": [1.3, 0.0, 0.0], "CA": [0.0, 0.0, 0.0], "C": [0.0, 1.3, 0.0], "O": [0.6, 2.3, 0.0]}
SIDE = {"CB": [-1.0, -0.8, 0.5], "CG": [-2.2, -0.2, 1.2], "CD1": [-3.3, -1.2, 1.4], "CD2": [-2.7, 1.0, 0.5]}
RESIDUES = ("LEU", "ALA", "SER", "GLY", "LYS", "PHE", "HIS", "TYR")


def write_protein(path: str, n_res: int = 40, seed: int = 0, chains=("A", "B"), spread: float = 6.0) -> np.ndarray:
    """A seeded receptor: n_res residues over ``chains`` (the second chain
    far from the first), backbone atoms N, CA, C, O and, for LEU, its side
    chain; an altloc B copy of one atom (the parser keeps the first) and a
    hydrogen (the featurization drops it).
    -> the C-alpha positions [n_res, 3]."""
    rng = np.random.RandomState(seed)
    lines, serial, cas = [], 1, []
    for i in range(n_res):
        chain = chains[min(i * len(chains) // n_res, len(chains) - 1)]
        base = rng.randn(3) * spread + (0.0 if chain == chains[0] else 60.0)
        name = RESIDUES[rng.randint(len(RESIDUES))]
        atoms = dict(BACKBONE, **(SIDE if name == "LEU" else {}))
        for aname, off in atoms.items():
            x, y, z = base + off
            lines.append(f"ATOM  {serial:5d} {aname:<4s} {name} {chain}{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                         f"          {aname[0]:>2s}")
            serial += 1
            if i == 2 and aname == "CA":  # an alternate location: the first wins
                lines.append(f"ATOM  {serial:5d} {aname:<4s}B{name} {chain}{i + 1:4d}    {x + 1:8.3f}{y:8.3f}{z:8.3f}"
                             f"  0.50  0.00           C")
                serial += 1
        if i == 3:
            lines.append(f"ATOM  {serial:5d}  H   {name} {chain}{i + 1:4d}    {base[0]:8.3f}{base[1] + 1:8.3f}"
                         f"{base[2]:8.3f}  1.00  0.00           H")
            serial += 1
        cas.append(base)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")
    return np.round(np.asarray(cas), 3)


def ligand(seed: int = 0, smiles: str = SMILES) -> mol_io.Molecule:
    """The seeded ligand: ``smiles`` with its hydrogens, embedded in 3D."""
    return mol_from_smiles(smiles, seed=seed)


def write_complex(root: str, name: str, seed: int = 0, n_res: int = 40, smiles: str = SMILES) -> tuple:
    """{root}/{name}/{name}_protein_processed.pdb and {name}_ligand.sdf, the
    ligand placed at the first C-alpha. -> (protein path, ligand path)."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    prot = os.path.join(d, f"{name}_protein_processed.pdb")
    ca = write_protein(prot, n_res=n_res, seed=seed)
    mol = ligand(seed, smiles)
    lig = os.path.join(d, f"{name}_ligand.sdf")
    mol_io.write_sdf(mol, mol.pos - mol.pos.mean(0) + ca[0] + 2.0, lig, name=name)
    return prot, lig


def test_written_files_parse_back(tmp_path):
    prot, lig = write_complex(str(tmp_path), "c0", seed=3)
    st = mol_io.parse_pdb(prot)
    assert len(st.residues) == 40 and set(st.chains()) == {"A", "B"}
    assert sum(1 in r.elements.values() for r in st.residues) == 1
    ca = write_protein(str(tmp_path / "again.pdb"), seed=3)
    np.testing.assert_allclose(np.stack([r.atoms["CA"] for r in st.residues]), ca, atol=1e-9)
    mol = mol_io.read_molecule(lig)
    want = ligand(3)
    assert mol.num_atoms == want.num_atoms and mol.bonds == want.bonds
    np.testing.assert_array_equal(mol.charges, want.charges)
    assert int(mol.charges.sum()) == 1 and (mol.atomic_nums == 1).sum() > 0


def test_ligand_is_seeded():
    a, b, c = ligand(0), ligand(0), ligand(1)
    np.testing.assert_array_equal(a.pos, b.pos)
    assert not np.array_equal(a.pos, c.pos)
