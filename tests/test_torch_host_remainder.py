"""The port's host remainder against the JAX package: the gnina hook, the
online ESM2 run's refusal and five public helpers.

* ``eval/gnina``: a stand-in ``gnina`` script put on ``PATH`` (it writes the
  poses it is given back with ``CNNscore`` fields, and keeps a copy of its
  input) takes both packages' ``gnina_rescore`` calls: the same input SDF
  byte for byte, the same command line and the same scores; the parser
  against the JAX one on both property-header spellings and a value that is
  not a number; without the binary both return None.
* ``data/esm_prep.compute_embeddings`` raises the JAX module's
  ``RuntimeError`` without the ``esm`` package (a run with ESM weights needs
  a download); with a stand-in ``esm`` module (a small seeded network in
  ESM's interface) the port on ``device="cpu"`` gives the JAX function's
  embeddings for a two-chain structure.
* ``ops/geometry.rigid_transform_independent``, ``ops/poses.masked_mean``,
  ``ops/graph_builders.count_overflow``, ``ops/schedules.
  get_inverse_schedule`` and ``sigmoid_np`` within 1e-5 (the Kabsch fit's
  rotation vector 1e-4) of the JAX functions on seeded inputs.
"""

import os
import stat
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.data import esm_prep as jesm_prep, mol_io as jmol_io
from confidence_bootstrapping_tpu.eval import gnina as jgnina
from confidence_bootstrapping_tpu.ops import geometry as jgeometry, graph_builders as jgraph, poses as jposes, \
    schedules as jschedules
from confidence_bootstrapping_tpu_torch.data import esm_prep, mol_io
from confidence_bootstrapping_tpu_torch.eval import gnina
from confidence_bootstrapping_tpu_torch.ops import geometry, graph_builders, poses, schedules

STAND_IN = """#!{python}
import shutil, sys
args = sys.argv[1:]
lig, out = args[args.index("--ligand") + 1], args[args.index("--out") + 1]
calls = {log!r}
with open(calls, "a") as f:
    f.write(" ".join(a if not a.startswith("/") else "PATH" for a in args) + "\\n")
shutil.copy(lig, calls + ".%d" % sum(1 for _ in open(calls)))
records = open(lig).read().split("$$$$\\n")[:-1]
bonus = 0.5 if "--local_only" in args else 0.0
with open(out, "w") as f:
    for i, rec in enumerate(records):
        head = ">  <CNNscore>" if i % 2 else "> <CNNscore>"
        f.write(rec.replace("M  END\\n", "M  END\\n> <minimizedAffinity>\\n-7.1\\n\\n" + head + "\\n"
                            + "%.4f" % (0.1 * (i + 1) + bonus) + "\\n\\n") + "$$$$\\n")
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = str(tmp_path / "calls.log")
    exe = bindir / "gnina"
    exe.write_text(STAND_IN.format(python=sys.executable, log=log))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    return log


@pytest.mark.parametrize("minimize", [False, True])
def test_gnina_rescore_through_a_stand_in_binary(stand_in, tmp_path, minimize):
    assert gnina.have_gnina() and jgnina.have_gnina()
    smiles = "CC(=O)Nc1ccc(O)cc1"
    mol, jmol = mol_io.parse_smiles(smiles), jmol_io.parse_smiles(smiles)
    rng = np.random.RandomState(4)
    poses_ = mol.pos[None] + rng.randn(3, mol.num_atoms, 3).astype(np.float32)
    protein = str(tmp_path / "protein.pdb")
    got = gnina.gnina_rescore(mol, poses_, protein, minimize=minimize)
    want = jgnina.gnina_rescore(jmol, poses_, protein, minimize=minimize)
    np.testing.assert_allclose(got, np.asarray([0.1, 0.2, 0.3]) + (0.5 if minimize else 0.0), rtol=1e-6)
    np.testing.assert_array_equal(got, want)
    calls = open(stand_in).read().splitlines()
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0].endswith("--local_only" if minimize else "--score_only")
    assert open(stand_in + ".1").read() == open(stand_in + ".2").read()
    back = mol_io.parse_sdf(open(stand_in + ".1").read().split("$$$$\n")[2] + "$$$$\n", is_text=True)
    np.testing.assert_allclose(back.pos, poses_[2], atol=1e-4)


def test_cnn_score_parser_matches_jax(tmp_path):
    text = ("a\n\n\n  0  0  0  0  0  0  0  0  0  0999 V2000\nM  END\n> <CNNscore>\n0.731\n\n$$$$\n"
            "b\n\n\n  0  0  0  0  0  0  0  0  0  0999 V2000\nM  END\n>  <CNNscore>\n-1e-3\n\n> <CNNaffinity>\n5.5\n\n"
            "$$$$\nc\n\n\n  0  0  0  0  0  0  0  0  0  0999 V2000\nM  END\n> <CNNscore>\nnan?\n\n$$$$\n")
    path = tmp_path / "scored.sdf"
    path.write_text(text)
    got = gnina.parse_cnn_scores_from_sdf(str(path))
    assert got == jgnina.parse_cnn_scores_from_sdf(str(path)) == [0.731, -1e-3]


def test_gnina_without_the_binary_returns_none():
    mol = mol_io.parse_smiles("CCO")
    missing = "gnina-not-installed-here"
    assert not gnina.have_gnina(missing) and not jgnina.have_gnina(missing)
    assert gnina.gnina_rescore(mol, mol.pos[None], "protein.pdb", binary=missing) is None
    assert jgnina.gnina_rescore(jmol_io.parse_smiles("CCO"), mol.pos[None], "protein.pdb", binary=missing) is None


def test_compute_embeddings_refuses_without_esm(monkeypatch):
    monkeypatch.setitem(sys.modules, "esm", None)  # an import of esm fails, as in this image
    with pytest.raises(RuntimeError) as want:
        jesm_prep.compute_embeddings({})
    with pytest.raises(RuntimeError, match="`esm` package is not installed") as got:
        esm_prep.compute_embeddings({})
    assert str(got.value) == str(want.value) and isinstance(got.value.__cause__, ImportError)


class StandInESM(torch.nn.Module):
    """ESM2's interface at a small size: tokens [B, T] -> {"representations":
    {num_layers: [B, T, 8]}}."""

    num_layers = 2

    def __init__(self):
        super().__init__()
        torch.manual_seed(5)
        self.emb = torch.nn.Embedding(24, 8)
        self.mix = torch.nn.Linear(8, 8)

    def forward(self, toks, repr_layers):
        return {"representations": {layer: torch.tanh(self.mix(self.emb(toks))) for layer in repr_layers}}


def stand_in_esm() -> types.ModuleType:
    """An ``esm`` module whose pretrained loader returns ``StandInESM`` and
    a batch converter that brackets a sequence with begin and end tokens."""
    letters = "ACDEFGHIKLMNPQRSTVWYX"

    def convert(batch):
        toks = torch.tensor([[21] + [letters.index(c) for c in seq] + [22] for _, seq in batch])
        return [label for label, _ in batch], [seq for _, seq in batch], toks

    alphabet = types.SimpleNamespace(get_batch_converter=lambda: convert)
    esm = types.ModuleType("esm")
    esm.pretrained = types.SimpleNamespace(load_model_and_alphabet=lambda name: (StandInESM(), alphabet))
    return esm


def test_compute_embeddings_matches_jax_with_a_stand_in_esm(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "esm", stand_in_esm())
    residues = [("A", i, res) for i, res in enumerate(("MET", "LYS", "ALA", "GLY", "TRP"), 1)]
    residues += [("B", i, res) for i, res in enumerate(("SER", "HIS", "ASP"), 1)]
    path = str(tmp_path / "two_chains.pdb")
    with open(path, "w") as f:
        for n, (chain, seq, res) in enumerate(residues, 1):
            f.write(f"ATOM  {n:5d}  CA  {res} {chain}{seq:4d}    {n:8.3f}{0.0:8.3f}{0.0:8.3f}  1.00  0.00           C\n")
    got = esm_prep.compute_embeddings({"two": mol_io.parse_pdb(path)}, device="cpu")
    want = jesm_prep.compute_embeddings({"two": jmol_io.parse_pdb(path)})
    assert got.keys() == want.keys() == {"two"} and got["two"].shape == (8, 8)
    np.testing.assert_array_equal(got["two"], want["two"])


def test_helpers_match_jax():
    rng = np.random.RandomState(9)
    A = rng.randn(3, 12, 3).astype(np.float32)
    rot = geometry.axis_angle_to_matrix(torch.as_tensor(rng.randn(3, 3).astype(np.float32))).numpy()
    B = np.einsum("bni,bji->bnj", A, rot) + rng.randn(3, 1, 3).astype(np.float32) + 0.01 * rng.randn(3, 12, 3)
    B = B.astype(np.float32)
    mask = rng.rand(3, 12) > 0.25
    for m in (None, mask):
        t, rv = geometry.rigid_transform_independent(torch.as_tensor(A), torch.as_tensor(B),
                                                     None if m is None else torch.as_tensor(m))
        jt, jrv = jgeometry.rigid_transform_independent(jnp.asarray(A), jnp.asarray(B),
                                                        None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rv.numpy(), np.asarray(jrv), rtol=1e-4, atol=1e-4)

    x3, x2 = rng.randn(3, 12, 5).astype(np.float32), rng.randn(3, 12).astype(np.float32)
    mask[1] = False  # an all-masked row: the 1e-12 floor, zero
    for x in (x3, x2):
        for keep in (False, True):
            got = poses.masked_mean(torch.as_tensor(x), torch.as_tensor(mask), 1, keep)
            want = jposes.masked_mean(jnp.asarray(x), jnp.asarray(mask), 1, keep)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    a, b = (rng.rand(2, 20, 3) * 6).astype(np.float32), (rng.rand(2, 30, 3) * 6).astype(np.float32)
    am, bm = rng.rand(2, 20) > 0.1, rng.rand(2, 30) > 0.1
    for other, om, k, excl in ((b, bm, 4, False), (b, bm, 8, False), (a, am, 4, True)):
        got = graph_builders.count_overflow(torch.as_tensor(a), torch.as_tensor(other), 3.0, torch.as_tensor(am),
                                            torch.as_tensor(om), k, excl)
        want = jgraph.count_overflow(jnp.asarray(a), jnp.asarray(other), 3.0, am, om, k, excl)
        assert int(got) == int(want) and int(want) > 0

    t = np.linspace(0, 1, 11)
    for alpha, beta in ((1.0, 1.0), (2.0, 0.5)):
        np.testing.assert_allclose(schedules.get_inverse_schedule(t, alpha, beta),
                                   jschedules.get_inverse_schedule(t, alpha, beta), rtol=1e-12)
    np.testing.assert_allclose(schedules.sigmoid_np(t * 8 - 4), jschedules.sigmoid_np(t * 8 - 4), rtol=1e-12)
