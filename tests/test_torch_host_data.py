"""The port's host data layer against the JAX package's: the same seeded
synthetic files (tests/test_torch_files.py) through both packages' parsers,
writers, featurization (every conformer mode, receptor atoms, side chains,
chain cutoff), SMILES embedding, ``ComplexDataset`` (cache keys, a cache the
JAX package wrote, a worker pool), the directory and MOAD loaders, the ESM
FASTA half and its gate, and the relax hooks; then 1a0q written back to files
from the committed cache and featurized again (``chip_smoke.py`` phase 13's
first check). Every output is held exactly (``np.array_equal``, the same
bytes): both packages run the same numpy and scipy code on the same input.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import chip_smoke
from confidence_bootstrapping_tpu.data import conformers as jconformers
from confidence_bootstrapping_tpu.data import dataset as jdataset
from confidence_bootstrapping_tpu.data import esm_prep as jesm
from confidence_bootstrapping_tpu.data import featurize as jfeaturize
from confidence_bootstrapping_tpu.data import moad as jmoad
from confidence_bootstrapping_tpu.data import mol_io as jmol_io
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.data import conformers, dataset, esm_prep, featurize, moad, mol_io
from confidence_bootstrapping_tpu_torch.eval import relax
from test_torch_files import SMILES, ligand, write_complex, write_protein

IBUPROFEN = "CC(C)Cc1ccc(cc1)C(C)C(=O)O"


def same(a, b, what=""):
    """Two parsed or featurized objects hold the same values, field by field."""
    if hasattr(a, "_fields"):  # HostComplex
        assert a._fields == b._fields
        for f in a._fields:
            same(getattr(a, f), getattr(b, f), f)
    elif hasattr(a, "__dataclass_fields__"):  # Molecule, Residue, ProteinStructure
        for f in a.__dataclass_fields__:
            same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, (list, tuple)) and a and not np.isscalar(a[0]) and not isinstance(a[0], tuple):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            same(x, y, what)
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            same(a[k], b[k], f"{what}[{k}]")
    elif a is None or b is None:
        assert a is None and b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what  # NaN: an undefined chi angle
        assert a.dtype == b.dtype, what


def write_mol2(path, mol):
    types_ = {1: "H", 6: "C.3", 7: "N.3", 8: "O.2"}
    lines = ["@<TRIPOS>MOLECULE", "lig", f" {mol.num_atoms} {len(mol.bonds)} 0 0 0", "SMALL", "GASTEIGER", "",
             "@<TRIPOS>ATOM"]
    for i, (z, p, c) in enumerate(zip(mol.atomic_nums, mol.pos, mol.charges)):
        lines.append(f"{i + 1:7d} A{i:<4d} {p[0]:10.4f} {p[1]:10.4f} {p[2]:10.4f} {types_[int(z)]:<6s} 1  LIG "
                     f"{float(c):8.4f}")
    lines.append("@<TRIPOS>BOND")
    for k, (i, j, o) in enumerate(mol.bonds):
        lines.append(f"{k + 1:6d} {i + 1:5d} {j + 1:5d} {'ar' if o == 4 else o}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    prot, lig = write_complex(str(root), "c0", seed=1, n_res=48)
    mol2 = str(root / "c0.mol2")
    write_mol2(mol2, ligand(1))
    return dict(root=str(root), prot=prot, lig=lig, mol2=mol2)


@pytest.mark.parametrize("kind", ["sdf", "mol2", "smiles", "pdb"])
def test_parsers_match_jax(files, kind):
    if kind == "sdf":
        got, want = mol_io.parse_sdf(files["lig"]), jmol_io.parse_sdf(files["lig"])
        assert got.num_atoms == ligand(1).num_atoms
    elif kind == "mol2":
        got, want = mol_io.read_molecule(files["mol2"]), jmol_io.read_molecule(files["mol2"])
        assert sum(o == 4 for _, _, o in got.bonds) == 12
    elif kind == "smiles":
        for smi in (SMILES, "[NH3+]CC([O-])=O", "C1CC2(CC1)CCC%10CC2%10", "c1ccc2[nH]ccc2c1/C=C\\Br"):
            got, want = mol_io.parse_smiles(smi), jmol_io.parse_smiles(smi)
            same(got, want)
            same(mol_io.parse_smiles(smi, add_hs=False), jmol_io.parse_smiles(smi, add_hs=False))
        with pytest.raises(ValueError):
            mol_io.parse_smiles("CC.O")
    else:
        got, want = mol_io.parse_pdb(files["prot"]), jmol_io.parse_pdb(files["prot"])
        assert got.sequence() == want.sequence() and list(got.chains()) == list(want.chains())
        assert got.sequence("B") == want.sequence("B") != ""
    same(got, want)


def test_writers_write_the_same_bytes(tmp_path):
    mol = ligand(2)
    traj = mol.pos[None] + np.random.RandomState(0).randn(3, *mol.pos.shape)
    for pkg, name in ((mol_io, "port"), (jmol_io, "jax")):
        m = pkg.Molecule(mol.atomic_nums, mol.pos, mol.bonds, mol.charges, "lig")
        pkg.write_sdf(m, mol.pos + 0.5, str(tmp_path / f"{name}.sdf"), props={"confidence": 0.25})
        pkg.write_pdb_trajectory(m, traj, str(tmp_path / f"{name}.pdb"))
    for ext in ("sdf", "pdb"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    np.testing.assert_allclose(mol_io.parse_sdf(str(tmp_path / "port.sdf")).pos, mol.pos + 0.5, atol=5e-5)


@pytest.mark.parametrize("mode,kw", [
    ("input", dict(all_atoms=True, chain_cutoff=20.0, knn_only_graph=False)),
    ("input", dict(with_sidechains=True, c_alpha_max_neighbors=10)),
    ("generate", dict(all_atoms=True, atom_max_neighbors=6)),
    ("match", dict(with_sidechains=True, matching_tries=2, matching_popsize=4, matching_maxiter=3)),
])
def test_build_host_complex_matches_jax(files, mode, kw):
    lm = np.random.RandomState(0).randn(48, 8).astype(np.float32)
    args = [(pkg.read_molecule(files["lig"]), pkg.parse_pdb(files["prot"])) for pkg in (mol_io, jmol_io)]
    got = featurize.build_host_complex("c0", *args[0], lm_embeddings=lm, conformer_mode=mode, conformer_seed=3, **kw)
    want = jfeaturize.build_host_complex("c0", *args[1], lm_embeddings=lm, conformer_mode=mode, conformer_seed=3, **kw)
    same(got, want)
    assert len(got.tor_src) >= 5 and got.lig_f[:, 9].max() > 0  # rotatable bonds and rings
    if "chain_cutoff" in kw:
        assert len(got.rec_f) < 48  # the far chain left out
    assert (mode == "match") == (got.matching_rmsd > 0)
    np.testing.assert_array_equal(featurize.pocket_center(got), jfeaturize.pocket_center(want))


def test_rings_and_bridges_match_networkx():
    """The port's ring and bridge search (no networkx on the card's machine)
    on 100 seeded random graphs, some disconnected: the minimum cycle
    basis's ring sizes as networkx's, rotatable bonds and masks as the JAX
    package's (networkx's components)."""
    import networkx as nx

    for seed in range(100):
        rng = np.random.RandomState(seed)
        n = 5 + seed % 30
        bonds = [(i, int(rng.randint(0, i)), 1) for i in range(1, n)]
        bonds += [(int(a), int(b), 1) for a, b in rng.randint(0, n, (seed % 6, 2)) if a != b]
        if seed % 7 == 0:
            bonds = bonds[:-1]
        g = nx.Graph()
        g.add_nodes_from(range(n))
        g.add_edges_from((i, j) for i, j, _ in bonds)
        assert sorted(map(len, featurize.minimum_cycle_basis(n, bonds))) == sorted(map(len, nx.minimum_cycle_basis(g)))
        for a, b in zip(featurize.get_transformation_mask(n, bonds), jfeaturize.get_transformation_mask(n, bonds)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smiles", [SMILES, "CC(C)C(=O)O"])
def test_mol_from_smiles_matches_jax(smiles):
    same(conformers.mol_from_smiles(smiles, seed=4), jconformers.mol_from_smiles(smiles, seed=4))
    mol = ligand(4, smiles).remove_hs()
    np.testing.assert_array_equal(conformers.get_dihedral_tuples(mol.num_atoms, mol.bonds),
                                  jconformers.get_dihedral_tuples(mol.num_atoms, mol.bonds))


def test_complex_dataset_caches_and_workers(tmp_path, monkeypatch):
    """The same cache keys; a cache the JAX package wrote read by the port
    without featurizing; a 2-worker pool's cache equal to a serial one's;
    the same padded batches from the same seed (a one-ring ligand: the JAX
    package's bucket holds 2L bond edges)."""
    entries = [(n, *write_complex(str(tmp_path / "data"), n, seed=i, n_res=30 + 10 * i, smiles=IBUPROFEN))
               for i, n in enumerate(("a", "b"))]
    jds = jdataset.ComplexDataset(entries, cache_dir=str(tmp_path / "jax"))
    serial = dataset.ComplexDataset(entries, cache_dir=str(tmp_path / "serial"))
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "serial"))
    assert all(serial._cache_key(*e) == jds._cache_key(*e) for e in entries)
    for a, b in zip(serial.complexes, jds.complexes):
        same(a, b)

    monkeypatch.setattr(featurize, "build_host_complex", lambda *a, **k: pytest.fail("the cache was not read"))
    from_jax = dataset.ComplexDataset(entries, cache_dir=str(tmp_path / "jax"))
    assert type(from_jax.complexes[0]) is tcg.HostComplex and type(from_jax.mols["a"]) is mol_io.Molecule
    for a, b in zip(from_jax.complexes, jds.complexes):
        same(a, b)
    monkeypatch.undo()

    pool = dataset.ComplexDataset(entries, cache_dir=str(tmp_path / "pool"), num_workers=2)
    for f in os.listdir(tmp_path / "serial"):
        assert (tmp_path / "pool" / f).read_bytes() == (tmp_path / "serial" / f).read_bytes()
    for a, b in zip(pool.complexes, serial.complexes):
        same(a, b)

    want = jds.epoch_batches(1, np.random.RandomState(0))
    got = dataset.ComplexDataset(entries, cache_dir=str(tmp_path / "serial"), device="cpu").epoch_batches(
        1, np.random.RandomState(0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for f in ("lig_pos", "lig_f", "rec_pos", "rec_nbr", "tor_dihedral"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)), err_msg=f)


def test_directory_and_moad_loaders(tmp_path):
    data = tmp_path / "data"
    for i, n in enumerate(("x1", "x2", "y1")):
        _, lig = write_complex(str(data), n, seed=10 + i, n_res=24)
    mol = mol_io.read_molecule(lig)
    mol_io.write_sdf(mol, mol.pos + 1.0, lig.replace("_ligand.sdf", "_ligand_0.sdf"))  # an alternative pose of y1
    same(dataset.discover_dir(str(data)), jdataset.discover_dir(str(data)))
    same(dataset.discover_alt_poses(lig, mol.remove_hs().num_atoms),
         jdataset.discover_alt_poses(lig, mol.remove_hs().num_atoms))
    assert len(dataset.discover_alt_poses(lig, mol.remove_hs().num_atoms)) == 1
    splits, c2l = tmp_path / "splits.pkl", tmp_path / "c2l.pkl"
    splits.write_bytes(pickle.dumps({"PDBBind": ["cx"], "test": ["cx", "cy"]}))
    c2l.write_bytes(pickle.dumps({"cx": ["x1", "x2", "missing"], "cy": ["y1"]}))
    assert moad.load_cluster_splits(str(splits), "train") == jmoad.load_cluster_splits(str(splits), "train") == ["cx"]
    assert moad.load_cluster_to_ligands(str(c2l)) == jmoad.load_cluster_to_ligands(str(c2l))
    kw = dict(splits_pkl=str(splits), cluster_to_ligands_pkl=str(c2l), split="test", max_receptor_size=100,
              remove_promiscuous_targets=5)
    got = moad.MOADDataset(str(data), cache_path=str(tmp_path / "pc"), **kw)
    want = jmoad.MOADDataset(str(data), cache_path=str(tmp_path / "jc"), **kw)
    assert got.split_clusters == want.split_clusters == ["cx", "cy"] and got.cluster_to_ligands == want.cluster_to_ligands
    assert len(got) == len(want) == 2
    same(got.get_by_name("y1"), want.get_by_name("y1"))
    same(got.get(0), want.get(0))


def test_esm_prep_fasta_and_gate(tmp_path):
    structures = {}
    for i in range(3):
        write_protein(str(tmp_path / f"p{i}.pdb"), n_res=12, seed=i % 2)
        structures[f"c{i}"] = (mol_io.parse_pdb(str(tmp_path / f"p{i}.pdb")), jmol_io.parse_pdb(str(tmp_path / f"p{i}.pdb")))
    got = esm_prep.write_dedup_fasta({k: v[0] for k, v in structures.items()}, str(tmp_path / "port.fasta"))
    want = jesm.write_dedup_fasta({k: v[1] for k, v in structures.items()}, str(tmp_path / "jax.fasta"))
    assert got == want and (tmp_path / "port.fasta").read_bytes() == (tmp_path / "jax.fasta").read_bytes()
    assert got[("c0", "A")] == got[("c2", "A")]  # a sequence seen twice gets one id
    ext = tmp_path / "extract"
    ext.mkdir()
    for sid in set(got.values()):
        torch.save({"label": str(sid), "representations": {33: torch.randn(6, 4)}}, ext / f"{sid}.pt")
    a = esm_prep.fold_esm_outputs(str(ext), got, str(tmp_path / "port.pt"))
    b = jesm.fold_esm_outputs(str(ext), want, str(tmp_path / "jax.pt"))
    same(a, b)
    same(esm_prep.load_embeddings_pt(str(tmp_path / "port.pt")), b)
    with pytest.raises(RuntimeError) as e:
        esm_prep.predict_structure("MKT", str(tmp_path / "x.pdb"))
    with pytest.raises(RuntimeError) as je:
        jesm.predict_structure("MKT", str(tmp_path / "x.pdb"))
    assert str(e.value) == str(je.value) and "esm" in str(e.value)


def test_relax_hooks_degrade_without_binaries():
    pos = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    mol = mol_io.Molecule(np.full(5, 6), pos, [(i, i + 1, 1) for i in range(4)], np.zeros(5, dtype=int))
    assert not relax.have_binary("definitely_not_a_binary_xyz")
    assert relax.obrms("/nonexistent.sdf", mol, pos[None], binary="definitely_not_a_binary_xyz") is None
    assert relax.xtb_relax(mol, pos, binary="definitely_not_a_binary_xyz") is None
    if not relax.have_binary("obrms"):
        assert relax.obrms("/nonexistent.sdf", mol, pos[None]) is None
    if not relax.have_binary("xtb"):
        assert relax.xtb_relax(mol, pos) is None


def test_1a0q_written_back_to_files(tmp_path):
    """chip_smoke.py phase 13's inputs: 1a0q's receptor and ligand written
    from the committed cache and featurized by both packages (equal), the
    port's result held against the cache as phase 13's first check holds it
    (features, edges, torsions exact; positions within the files' rounding;
    the kNN lists as sets; the 3183 receptor atoms as written)."""
    prot, lig, _, atoms, atom_res = chip_smoke.write_1a0q(str(tmp_path))
    got = featurize.build_host_complex("1a0q", mol_io.read_molecule(lig), mol_io.parse_pdb(prot), all_atoms=True)
    want = jfeaturize.build_host_complex("1a0q", jmol_io.read_molecule(lig), jmol_io.parse_pdb(prot), all_atoms=True)
    same(got, want)
    chip_smoke.featurization_check(types.SimpleNamespace(hc=got, featurize_s=0.0), atoms, atom_res)
