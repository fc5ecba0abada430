"""The port's training-side data layers against the JAX package's, on the CPU.

Seeded synthetic files through both packages:

* ``data/pdbbind``: ``PDBBindDataset`` (name-list split, limit,
  multiplicity), ``CombinedDataset.epoch_batches`` over featurized complexes
  mixed with the bootstrapping dataset's padded dicts, and
  ``construct_loader_entries`` in every mode (pdbbind, moad, combined,
  generalisation); the same complexes and the same batches in the same order
  for the same ``RandomState``, exactly;
* ``data/pdb_sidechain``: ``compute_cg_features`` for every amino acid and
  ``PDBSidechainDataset`` in the cases of JAX ``tests/test_host_utils.py:
  271-360`` (chemical groups, list.csv splits, random SMILES ligands,
  multiplicity and merged clusters, served items), exactly;
* ``data/preprocess_pdb``: hetero-ligand extraction and ``split_biounit`` on
  seeded synthetic biounits, the same files byte for byte; the blacklist
  asset byte-equal to the JAX package's; ``assign_bond_orders_from_template``
  against the networkx (VF2) version on seeded molecules with their atoms
  shuffled, equal up to the molecule's symmetry (where equal mappings exist
  the two matchers may pick different ones), and None on the same
  non-matching templates.
"""

import filecmp
import os
import types

import numpy as np
import pytest

from confidence_bootstrapping_tpu.bootstrapping import offline_dataset as joffline
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.data import pdb_sidechain as jside
from confidence_bootstrapping_tpu.data import pdbbind as jpdbbind
from confidence_bootstrapping_tpu.data import preprocess_pdb as jprep
from confidence_bootstrapping_tpu_torch.bootstrapping import offline_dataset
from confidence_bootstrapping_tpu_torch.data import mol_io, pdb_sidechain, pdbbind, preprocess_pdb
from confidence_bootstrapping_tpu_torch.data.conformers import mol_from_smiles
from confidence_bootstrapping_tpu_torch.eval.rmsd import graph_automorphisms
from test_torch_files import write_complex
from test_torch_host_data import same
from test_torch_torsional import _same_batch

# ----------------------------------------------------------------------------- PDBBind and the loader modes

ONE_RING = "CC(C)Cc1ccc(cc1)C(C)C(=O)O"  # within the JAX package's 2L bond slots


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    for i, n in enumerate(("p0", "p1", "p2")):
        write_complex(str(root / "pdbbind"), n, seed=20 + i, n_res=20 + 12 * i, smiles=ONE_RING)
    (root / "split.txt").write_text("p2\np0\n")
    for i, n in enumerate(("1abc", "2xyz")):
        write_sidechain_pdb(str(root / "side" / f"{n}.pdb"), n_res=40, seed=i)  # 40: the default window of 10 leaves 16
    return root


def _args(root, mode, **kw):
    import argparse

    return argparse.Namespace(dataset=mode, pdbbind_dir=str(root / "pdbbind"), moad_dir=str(root / "pdbbind"),
                              pdbsidechain_dir=str(root / "side"), split_train=None, moad_splits_pkl=None,
                              cluster_to_ligands_pkl=None, limit_complexes=0, **kw)


def _padded_items(ds, n=3, seed=0):
    """Buffer-style items (padded complex at a jittered pose, name, confidence)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        hc = ds.get(k % len(ds))
        p = jcg.pad_complex(hc, jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src),
                                                len(hc.rec_f)), lm_dim=0)
        p = dict(p, lig_pos=p["lig_pos"] + rng.randn(*p["lig_pos"].shape).astype(np.float32))
        out.append((p, hc.name, float(rng.randn())))
    return out


def test_pdbbind_dataset_and_combined_batches_equal_jax(data):
    kw = dict(split_path=str(data / "split.txt"), multiplicity=2)
    got = pdbbind.PDBBindDataset(str(data / "pdbbind"), cache_path=str(data / "pc"), device="cpu", **kw)
    want = jpdbbind.PDBBindDataset(str(data / "pdbbind"), cache_path=str(data / "jc"), **kw)
    assert got.names == want.names == ["p2", "p0"] and len(got) == len(want) == 4
    for i in range(4):
        same(got.get(i), want.get(i))
    assert sorted(os.listdir(data / "pc")) == sorted(os.listdir(data / "jc"))
    assert pdbbind.read_strings_from_txt(str(data / "split.txt")) == jpdbbind.read_strings_from_txt(
        str(data / "split.txt"))
    one = pdbbind.PDBBindDataset(str(data / "pdbbind"), cache_path=str(data / "pc"), limit_complexes=1, device="cpu")
    assert one.names == ["p0"]

    items = _padded_items(want)
    comb = pdbbind.CombinedDataset(got, offline_dataset.BootstrappingDataset(items, temperature=0.5, seed=3),
                                   pdbbind.PDBBindDataset(str(data / "pdbbind"), split_path=str(data / "split.txt"),
                                                          limit_complexes=0, cache_path=None, device="cpu",
                                                          all_atoms=True), device="cpu")
    jcomb = jpdbbind.CombinedDataset(want, joffline.BootstrappingDataset(items, temperature=0.5, seed=3),
                                     jpdbbind.PDBBindDataset(str(data / "pdbbind"), split_path=str(data / "split.txt"),
                                                             cache_path=None, all_atoms=True))
    assert len(comb) == len(jcomb) == 4 + 3 + 2 and comb.lm_dim() == jcomb.lm_dim() == 0
    rp, rj = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):
        a, b = comb.epoch_batches(2, rp), jcomb.epoch_batches(2, rj)
        assert len(a) == len(b) >= 5
        for x, y in zip(a, b):
            _same_batch(x, y)
    assert any(x.atom_pos is not None for x in a) and any(x.atom_pos is None for x in a)
    assert len(pdbbind.CombinedDataset(None, got, pdbbind.CombinedDataset()).datasets) == 1


@pytest.mark.parametrize("mode", ["pdbbind", "moad", "combined", "generalisation"])
def test_construct_loader_entries_equal_jax(mode, data):
    got = pdbbind.construct_loader_entries(_args(data, mode, cache_path=str(data / "pc")), device="cpu")
    want = jpdbbind.construct_loader_entries(_args(data, mode, cache_path=str(data / "jc")))
    assert [type(d).__name__ for d in got.datasets] == [type(d).__name__ for d in want.datasets]
    assert len(got) == len(want) > 0 and len(got.datasets) == {"combined": 2, "generalisation": 3}.get(mode, 1)
    rp, rj = np.random.RandomState(1), np.random.RandomState(1)
    a, b = got.epoch_batches(2, rp), want.epoch_batches(2, rj)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same_batch(x, y)
    with pytest.raises(ValueError, match="--moad_dir" if mode == "moad" else "--pdbbind_dir"):
        pdbbind.construct_loader_entries(types.SimpleNamespace(dataset=mode))


# ----------------------------------------------------------------------------- PDB side chains


def write_sidechain_pdb(path, n_res=24, seed=0):
    """A dense cluster of LEU residues (side chains buried by construction),
    as JAX ``tests/test_host_utils.py:250`` writes it."""
    rng = np.random.RandomState(seed)
    offs = {"N": [1.3, 0, 0], "CA": [0, 0, 0], "C": [0, 1.3, 0], "O": [0.6, 2.3, 0],
            "CB": [-1.0, -0.8, 0.5], "CG": [-2.2, -0.2, 1.2], "CD1": [-3.3, -1.2, 1.4], "CD2": [-2.7, 1.0, 0.5]}
    lines, serial = [], 1
    for i in range(n_res):
        base = rng.randn(3) * 3.0
        for aname, off in offs.items():
            x, y, z = base + off
            lines.append(f"ATOM  {serial:5d} {aname:<4s} LEU A{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                         f"          {aname[0]:>2s}")
            serial += 1
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")


def test_chemical_group_features_equal_jax():
    for aa in jside.CG_SMILES_INDICES:
        got, want = pdb_sidechain.compute_cg_features(aa), jside.compute_cg_features(aa)
        assert got is not None and want is not None, aa
        names, nums, charges, feats, bonds = got
        assert names == want[0] and bonds == want[4], aa
        for a, b in zip((nums, charges, feats), want[1:4]):
            np.testing.assert_array_equal(a, b, err_msg=aa)
    assert pdb_sidechain.compute_cg_features("XYZ") is None and pdb_sidechain.SIDECHAIN_BONDS == jside.SIDECHAIN_BONDS


def _side_pair(root, **kw):
    return (pdb_sidechain.PDBSidechainDataset(str(root), **kw), jside.PDBSidechainDataset(str(root), **kw))


@pytest.mark.parametrize("case", ["modes", "splits", "random_ligand", "multiplicity"])
def test_pdb_sidechain_dataset_equal_jax(case, data):
    root = data / "side"
    base = dict(min_contacts=2, buffer_residue_num=1)
    if case == "modes":
        runs = [dict(max_complexes_per_structure=2), dict(max_complexes_per_structure=2, use_cg_features=False)]
    elif case == "splits":
        (root / "list.csv").write_text("CHAINID,CLUSTER\n1abc_A,10\n2xyz_A,20\n")
        (root / "valid_clusters.txt").write_text("20\n")
        (root / "test_clusters.txt").write_text("\n")
        runs = [dict(max_complexes_per_structure=1, split=s) for s in ("train", "val", "test")]
    elif case == "random_ligand":
        runs = [dict(max_complexes_per_structure=1, limit_structures=1, add_random_ligand=True,
                     smiles_list=["CCO", "CC(C)O", "CCCC(=O)N"], seed=4)]
    else:
        runs = [dict(max_complexes_per_structure=2, multiplicity=3), dict(max_complexes_per_structure=2,
                                                                            merge_clusters=2)]
    try:
        for kw in runs:
            got, want = _side_pair(root, **base, **kw)
            assert len(got) == len(want) and got.names == want.names and got.clusters == want.clusters, kw
            assert got.cluster_to_names == want.cluster_to_names
            for a, b in zip(got.complexes, want.complexes):
                same(a, b)
            for n in got.mols:
                same(got.mols[n], want.mols[n])
            for i in range(3 * len(got)):  # served items: the same draws
                assert got.get(i).name == want.get(i).name
            if case == "modes" and kw.get("use_cg_features", True):
                assert len(got.complexes[0].lig_f) == 8 and got.complexes[0].lig_f[:, 2].any()
            if case == "splits":
                assert all(c.name.startswith({"train": "1abc", "val": "2xyz"}.get(kw["split"], "none"))
                           for c in got.complexes)
    finally:
        for f in ("list.csv", "valid_clusters.txt", "test_clusters.txt"):
            if (root / f).exists():
                (root / f).unlink()
    structure = mol_io.parse_pdb(str(root / "1abc.pdb"))
    from confidence_bootstrapping_tpu.data import mol_io as jmol_io

    np.testing.assert_array_equal(pdb_sidechain.count_contacts(structure, 4.0),
                                  jside.count_contacts(jmol_io.parse_pdb(str(root / "1abc.pdb")), 4.0))
    same(pdb_sidechain.sidechain_molecule(structure.residues[3]),
         jside.sidechain_molecule(jmol_io.parse_pdb(str(root / "1abc.pdb")).residues[3]))


# ----------------------------------------------------------------------------- preprocessing


SYMBOL = {1: "H", 6: "C", 7: "N", 8: "O", 16: "S"}


def _hetatm(serial, name, resname, chain, seq, xyz, el):
    x, y, z = xyz
    return (f"HETATM{serial:5d} {name:<4s} {resname:>3s} {chain}{seq:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
            f"          {el:>2s}")


def write_biounit(path, seed=0):
    """A seeded biounit: 12 protein residues, then hetero groups: water and
    sulfate (blacklisted), ethylbenzene with its hydrogens (EBZ), acetate
    (ACX), a phenol (PHL), a 2-atom group (too small)."""
    from test_torch_files import write_protein

    write_protein(path, n_res=12, seed=seed, chains=("A",))
    rng = np.random.RandomState(seed)
    lines = [l for l in open(path).read().splitlines() if l.startswith("ATOM")]
    serial = len(lines) + 1
    groups = [("HOH", [("O", 8, [0, 0, 0])]), ("SO4", [("S", 16, [0, 0, 0]), ("O1", 8, [1.5, 0, 0])])]
    for resname, smi in (("EBZ", "CCc1ccccc1"), ("ACX", "CC(=O)O"), ("PHL", "Oc1ccccc1")):
        mol = mol_from_smiles(smi, seed=seed)
        if resname != "EBZ":
            mol = mol.remove_hs()
        groups.append((resname, [(SYMBOL[int(z)] + str(k + 1), int(z), p)
                                 for k, (z, p) in enumerate(zip(mol.atomic_nums, mol.pos))]))
    groups.append(("XX2", [("C1", 6, [0, 0, 0]), ("C2", 6, [1.5, 0, 0])]))
    for g, (resname, atoms) in enumerate(groups):
        shift = rng.randn(3) * 4 + 12
        for name, z, p in atoms:
            lines.append(_hetatm(serial, name, resname, "A", 200 + g, np.asarray(p, float) + shift, SYMBOL[z]))
            serial += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")


def _up_to_symmetry(got, want, mol) -> bool:
    """got and want carry the same bond orders and charges on ``mol``'s
    atoms, up to an automorphism of ``mol``'s graph."""
    def key(m, perm):
        bonds = sorted((min(perm[i], perm[j]), max(perm[i], perm[j]), o) for i, j, o in m.bonds)
        charges = np.zeros(len(perm), int)
        charges[perm] = m.charges
        return bonds, charges.tolist()

    ident = np.arange(mol.num_atoms)
    target = key(want, ident)
    return any(key(got, perm) == target for perm in graph_automorphisms(mol.atomic_nums, mol.bonds))


def test_split_biounit_writes_the_jax_files(tmp_path):
    pdb = str(tmp_path / "1xyz.pdb")
    write_biounit(pdb, seed=3)
    got = [(n, m.name, m.atomic_nums.tolist(), m.bonds) for n, m in preprocess_pdb.extract_hetero_ligands(pdb)]
    want = [(n, m.name, m.atomic_nums.tolist(), m.bonds) for n, m in jprep.extract_hetero_ligands(pdb)]
    assert got == want and [g[0] for g in got] == ["EBZ_A202", "ACX_A203", "PHL_A204"]
    made = preprocess_pdb.split_biounit(pdb, str(tmp_path / "port"))
    assert made == jprep.split_biounit(pdb, str(tmp_path / "jax")) and len(made) == 3
    cmp = filecmp.dircmp(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(cmp.common_dirs) == sorted(made) and not cmp.left_only and not cmp.right_only
    for d in made:
        files = sorted(os.listdir(tmp_path / "port" / d))
        assert files == sorted(os.listdir(tmp_path / "jax" / d)) == [f"{d}_ligand.sdf", f"{d}_protein_processed.pdb"]
        for f in files:
            assert (tmp_path / "port" / d / f).read_bytes() == (tmp_path / "jax" / d / f).read_bytes(), f
    # with component templates: bond orders and the acetate's charge, equal up to symmetry
    lookup = {"EBZ": "CCc1ccccc1", "ACX": "CC([O-])=O", "PHL": "CCO"}  # PHL's template does not match
    a = preprocess_pdb.apply_smiles_templates(preprocess_pdb.extract_hetero_ligands(pdb), lookup)
    b = jprep.apply_smiles_templates(jprep.extract_hetero_ligands(pdb), lookup)
    for (n, m), (_, jm) in zip(a, b):
        assert _up_to_symmetry(m, jm, m), n
    assert all(o == 1 for _, _, o in a[2][1].bonds) and int(a[1][1].charges.sum()) == -1
    assert sorted(o for _, _, o in a[0][1].bonds) == [1, 1, 4, 4, 4, 4, 4, 4]
    assert filecmp.cmp(os.path.join(os.path.dirname(preprocess_pdb.__file__), "moad_ligand_blacklist.json"),
                       os.path.join(os.path.dirname(jprep.__file__), "moad_ligand_blacklist.json"), shallow=False)
    assert preprocess_pdb.load_moad_blacklist() == jprep.load_moad_blacklist()
    assert preprocess_pdb.LIGAND_BLACKLIST == jprep.LIGAND_BLACKLIST


TEMPLATE_SMILES = ("CCc1ccccc1", "CC(=O)[O-]", "C[NH+](C)CCc1ccc(cc1)C(=O)NCc1ccc2OCOc2c1", "OC(=O)c1ccncc1",
                   "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "c1ccc2[nH]ccc2c1", "C1CC2CCC1CC2", "NC(=[NH2+])NCCC")


@pytest.mark.parametrize("smiles", TEMPLATE_SMILES)
def test_bond_orders_from_template_match_networkx(smiles):
    """The molecule's heavy atoms shuffled (seeded), every bond single and
    no charge, as distance inference leaves them; its template from the
    SMILES. Then templates that do not match: another element, another
    connectivity at the same size, another size."""
    from confidence_bootstrapping_tpu.data import mol_io as jmol_io

    heavy = mol_from_smiles(smiles, seed=1).remove_hs()
    perm = np.random.RandomState(len(smiles)).permutation(heavy.num_atoms)
    inv = np.argsort(perm)
    bonds = [(int(inv[i]), int(inv[j]), 1) for i, j, _ in heavy.bonds]
    mol = mol_io.Molecule(heavy.atomic_nums[perm], heavy.pos[perm], bonds, np.zeros(heavy.num_atoms, int), "x")
    jmol = jmol_io.Molecule(mol.atomic_nums, mol.pos, mol.bonds, mol.charges, "x")
    got = preprocess_pdb.assign_bond_orders_from_template(mol_io.parse_smiles(smiles), mol)
    want = jprep.assign_bond_orders_from_template(jmol_io.parse_smiles(smiles), jmol)
    assert got is not None and want is not None
    assert _up_to_symmetry(got, want, mol)
    assert sorted((min(i, j), max(i, j)) for i, j, _ in got.bonds) == sorted((min(i, j), max(i, j)) for i, j, _ in bonds)
    assert sorted(o for _, _, o in got.bonds) == sorted(o for _, _, o in heavy.bonds)
    np.testing.assert_array_equal(np.sort(got.charges), np.sort(heavy.charges))
    n = mol.num_atoms
    wrong = [mol_io.Molecule(np.where(mol.atomic_nums == 6, 14, mol.atomic_nums), mol.pos, mol.bonds, mol.charges),
             mol_io.Molecule(mol.atomic_nums, mol.pos, [(i, (i + 1) % n, 1) for i in range(n)], mol.charges),
             mol_io.Molecule(mol.atomic_nums[:-1], mol.pos[:-1], [b for b in mol.bonds if max(b[:2]) < n - 1],
                             mol.charges[:-1])]
    for w in wrong:
        jw = jmol_io.Molecule(w.atomic_nums, w.pos, w.bonds, w.charges)
        assert preprocess_pdb.assign_bond_orders_from_template(mol_io.parse_smiles(smiles), w) is None
        assert jprep.assign_bond_orders_from_template(jmol_io.parse_smiles(smiles), jw) is None
