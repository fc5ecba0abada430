"""The port's docking and evaluator CLIs (``cli/dock.py``, ``cli/infer.py``)
on the CPU, against the JAX package's where the JAX CLI is cheap to run.

Seeded synthetic files (tests/test_torch_files.py) and tiny models (ns=8,
one receptor-embedding and two trunk layers; the confidence model all-atom
at lmax=2) saved as model directories. The port's dock writes one ranked SDF
per pose that parses back to its returned pose (within the file's 4
decimals); its featurized complex equals the JAX CLI's ``build_host_complex``
call exactly; the evaluator writes the JAX CLI's artifact names and
``metrics.json`` keys (the JAX CLI run with ``--no_model``), and a second
run reads the featurization cache, under the JAX CLI's file names. The flags
that need unported modules raise, and neither CLI falls back to the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.cli import infer as jinfer
from confidence_bootstrapping_tpu.data import featurize as jfeaturize
from confidence_bootstrapping_tpu.data import mol_io as jmol_io
from confidence_bootstrapping_tpu.eval import metrics as jmetrics
from confidence_bootstrapping_tpu_torch.cli import dock, infer
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, confidence_model_config
from confidence_bootstrapping_tpu_torch.data import featurize, mol_io
from confidence_bootstrapping_tpu_torch.models.factory import get_model
from confidence_bootstrapping_tpu_torch.train.checkpoints import save_model_dir
from test_torch_common import install_jax_tables
from test_torch_files import write_complex

SDF_ATOL = 1e-4  # A: the SDF's 4 decimals, and float32 coordinates tens of A from the origin
ARTIFACTS = ["centroid_distances.npy", "cold_variant.npy", "complex_names.npy", "confidences.npy", "metrics.json",
             "min_self_distances.npy", "rmsds.npy", "run_times.npy"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    paths = {n: write_complex(str(data), n, seed=i, n_res=30 + 40 * i) for i, n in enumerate(("c0", "c1"))}
    # the evaluator's set: one-ring ligands (the JAX package's bucket holds 2L bond edges; the port's more)
    for i, n in enumerate(("e0", "e1")):
        write_complex(str(root / "eval_data"), n, seed=7 + i, n_res=30 + 40 * i, smiles="CC(C)Cc1ccc(cc1)C(C)C(=O)O")
    dirs = {}
    for name, cfg in (("score", ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1,
                                                 lm_embedding_dim=0)),
                      ("conf", confidence_model_config(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=0,
                                                       crop_res_cap=32, crop_atom_cap=256))):
        dirs[name] = str(root / name)
        save_model_dir(dirs[name], cfg, get_model(cfg, device="cpu"))
    return dict(root=root, data=str(data), eval_data=str(root / "eval_data"), paths=paths, **dirs)


def dock_argv(files, out, *extra):
    prot, lig = files["paths"]["c0"]
    return ["--protein_path", prot, "--ligand", lig, "--samples", "3", "--batch_size", "2", "--inference_steps", "3",
            "--model_dir", files["score"], "--confidence_model_dir", files["conf"], "--out_dir", str(out),
            "--device", "cpu", *extra]


def test_dock_writes_ranked_sdfs(files, tmp_path, monkeypatch):
    """Two batches (3 poses at batch 2), the rerank, a trajectory per pose;
    with --pocket_knowledge the prior centres on the pocket."""
    install_jax_tables(monkeypatch)
    pos, conf = dock.main(dock_argv(files, tmp_path, "--save_visualisation"))
    out = tmp_path / "c0_ligand"
    ranked = sorted((f for f in os.listdir(out) if f.startswith("rank")), key=lambda f: int(f[4:].split("_")[0]))
    assert len(ranked) == 3 and len([f for f in os.listdir(out) if f.startswith("traj_")]) == 3
    assert pos.shape[0] == 3 and np.isfinite(pos).all() and np.isfinite(conf).all()
    d = dock.prepare(dock.get_parser().parse_args(dock_argv(files, tmp_path)), "cpu")
    order = np.argsort(-conf)
    for f, i in zip(ranked, order):
        mol = mol_io.parse_sdf(str(out / f))
        assert f.endswith(f"_confidence{conf[i]:.2f}.sdf") and mol.num_atoms == pos.shape[1]
        np.testing.assert_allclose(mol.pos - d.hc.orig_center, pos[i], rtol=0, atol=SDF_ATOL)
    frames = open(out / "traj_0.pdb").read().count("MODEL")
    assert frames == 4  # the prior and 3 steps
    pk, _ = dock.main(dock_argv(files, tmp_path / "pocket", "--pocket_knowledge", "--ode"))
    assert np.isfinite(pk).all()


def test_dock_csv_batch_mode(files, tmp_path, monkeypatch):
    """--protein_ligand_csv: a ligand file and a SMILES string, one result each."""
    install_jax_tables(monkeypatch)
    prot, lig = files["paths"]["c0"]
    csv = tmp_path / "in.csv"
    csv.write_text(f"complex_name,protein_path,ligand_path\nfrom_file,{prot},{lig}\nfrom_smiles,{prot},CCOc1ccccc1\n")
    out = dock.main(["--protein_ligand_csv", str(csv), "--samples", "2", "--inference_steps", "2", "--model_dir",
                     files["score"], "--out_dir", str(tmp_path), "--device", "cpu"])
    assert sorted(out) == ["from_file", "from_smiles"]
    assert out["from_smiles"][0].shape == (2, 9, 3) and np.isnan(out["from_file"][1]).all()  # no confidence model
    assert sorted(os.listdir(tmp_path / "from_smiles")) == ["rank1.sdf", "rank2.sdf"]


def test_dock_featurizes_as_the_jax_cli(files):
    """The complex the port's dock featurizes from a ligand file (a
    regenerated conformer from --seed, receptor atoms for the all-atom
    confidence model) and from a SMILES string, against the JAX CLI's call."""
    prot, lig = files["paths"]["c1"]
    for ligand, seed in ((lig, 5), ("CC(C)Cc1ccc(cc1)C(C)C(=O)O", 2)):
        args = dock.get_parser().parse_args(["--protein_path", prot, "--ligand", ligand, "--seed", str(seed)])
        got, heavy, lm = dock.featurize_complex(args, "x", need_atoms=True)
        if os.path.exists(ligand):
            mol, mode = jmol_io.read_molecule(ligand), "generate"
        else:
            from confidence_bootstrapping_tpu.data.conformers import mol_from_smiles

            mol, mode = mol_from_smiles(ligand, seed=seed), "input"
        want = jfeaturize.build_host_complex("x", mol, jmol_io.parse_pdb(prot), lm_embeddings=None,
                                             conformer_mode=mode, conformer_seed=seed, all_atoms=True)
        assert lm is None and heavy.num_atoms == len(got.lig_f)
        for f in got._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b)), f


def test_infer_artifacts_match_the_jax_cli(files, tmp_path, monkeypatch):
    """--no_model in both packages (the JAX CLI with the tiny score model):
    the same artifacts, metrics.json keys, complex names and cache file names,
    and the port reads the JAX CLI's cache; the port's run with both tiny
    models adds the confidence keys the JAX metrics add, and a second such
    run reads its cache (featurization switched off)."""
    install_jax_tables(monkeypatch)
    common = ["--data_dir", files["eval_data"], "--samples_per_complex", "3", "--inference_steps", "3",
              "--model_dir", files["score"], "--save_complexes"]
    jm = jinfer.main(common + ["--no_model", "--out_dir", str(tmp_path / "jax"), "--cache_path",
                               str(tmp_path / "jcache")])
    m = infer.main(common + ["--no_model", "--out_dir", str(tmp_path / "port"), "--cache_path",
                             str(tmp_path / "pcache"), "--device", "cpu"])
    artifacts = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == artifacts and set(ARTIFACTS + ["poses"]) <= set(artifacts)
    assert sorted(m) == sorted(jm) and m["n_complexes"] == jm["n_complexes"] == 2 and m["failures"] == jm["failures"] == 0
    assert json.load(open(tmp_path / "port" / "metrics.json")).keys() == m.keys()
    assert list(np.load(tmp_path / "port" / "complex_names.npy")) == list(np.load(tmp_path / "jax" / "complex_names.npy"))
    assert sorted(os.listdir(tmp_path / "pcache")) == sorted(os.listdir(tmp_path / "jcache"))
    assert np.load(tmp_path / "port" / "rmsds.npy").shape == (2, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "cold_variant.npy"), [True, True])

    both = common + ["--confidence_model_dir", files["conf"], "--out_dir", str(tmp_path / "both"), "--cache_path",
                     str(tmp_path / "both_cache"), "--device", "cpu", "--rec_phase_plan", "1:32"]
    m2 = infer.main(both)
    monkeypatch.setattr(featurize, "build_host_complex", lambda *a, **k: pytest.fail("the cache was not read"))
    for argv in (both, common + ["--no_model", "--out_dir", str(tmp_path / "from_jax"), "--cache_path",
                                 str(tmp_path / "jcache"), "--device", "cpu"]):
        again = infer.main(argv)
        assert again["n_complexes"] == 2 and again["failures"] == 0
    assert m2["n_complexes"] == 2 and m2["failures"] == 0
    conf_keys = set(jmetrics.performance_metrics(np.ones((2, 3)), np.ones((2, 3)), np.ones((2, 3)), np.ones((2, 3)),
                                                 np.ones(2)))
    assert set(m2) == set(jm) | conf_keys and set(m2) != set(jm)
    poses = np.load(tmp_path / "both" / "poses" / "e0.npy")
    assert poses.shape[0] == 3 and np.isfinite(poses).all()


def test_infer_selection_and_sampler_flags(files, tmp_path, monkeypatch):
    """discover_complexes as the JAX CLI's (--names_file, the MOAD split
    filter, --limit_complexes); a run with --no_rec_overlap_names,
    --resample_rdkit, low temperatures, per-manifold schedules, SVGD and the
    pocket-centred prior without its noise."""
    import argparse
    import pickle

    install_jax_tables(monkeypatch)
    (tmp_path / "names.txt").write_text("e1 e0 other")
    (tmp_path / "splits.pkl").write_bytes(pickle.dumps({"test": ["k1"], "PDBBind": ["k0"]}))
    (tmp_path / "c2l.pkl").write_bytes(pickle.dumps({"k0": ["e0"], "k1": ["e1"]}))
    for kw in (dict(names_file=str(tmp_path / "names.txt")), dict(limit_complexes=1),
               dict(moad_splits_pkl=str(tmp_path / "splits.pkl"), cluster_to_ligands_pkl=str(tmp_path / "c2l.pkl"))):
        args = dict(vars(jinfer.get_parser().parse_args(["--data_dir", files["eval_data"]])), **kw)
        got = infer.discover_complexes(argparse.Namespace(**args))
        assert got == jinfer.discover_complexes(argparse.Namespace(**args)) and got
    (tmp_path / "unseen.txt").write_text("e1")
    m = infer.main(["--data_dir", files["eval_data"], "--samples_per_complex", "3", "--inference_steps", "3",
                    "--model_dir", files["score"], "--out_dir", str(tmp_path / "run"), "--device", "cpu",
                    "--no_rec_overlap_names", str(tmp_path / "unseen.txt"), "--resample_rdkit",
                    "--temp_sampling_tr", "0.8", "--temp_psi_rot", "0.2", "--different_schedules",
                    "--tor_inf_sched_alpha", "2.0", "--pocket_knowledge", "--no_random_pocket",
                    "--svgd_weight_log_0", "-1", "--svgd_weight_log_1", "0", "--svgd_use_x0"])
    assert m["failures"] == 0 and m["no_overlap_n_complexes"] == 1 and "no_overlap_rmsds_below_2" in m


def test_infer_old_score_model_on_a_converted_directory(files, tmp_path, monkeypatch):
    """A legacy score model (sh_lmax=2, smooth edges) as a reference .pt and
    manifest, converted by ``cli.convert --old_score_model``, served by
    ``infer --old_score_model`` with the legacy all-atom confidence model
    for the rerank: every complex sampled and scored."""
    install_jax_tables(monkeypatch)
    import chip_smoke
    from confidence_bootstrapping_tpu_torch import yaml_io
    from confidence_bootstrapping_tpu_torch.cli import convert

    dirs = {}
    for name, cfg in (("score", ScoreModelConfig(ns=8, nv=2, sh_lmax=2, num_conv_layers=2, lm_embedding_dim=0,
                                                 old_score_model=True, smooth_edges=True)),
                      ("conf", confidence_model_config(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=0,
                                                       old_score_model=True, crop_res_cap=32, crop_atom_cap=256))):
        src = tmp_path / f"ref_{name}"
        src.mkdir()
        sd = chip_smoke.reference_state_dict(get_model(cfg, device="cpu", seed=3))
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, str(src / "model.pt"))
        manifest = dict(ns=8, nv=2, sh_lmax=2, num_conv_layers=2, all_atoms=cfg.all_atoms,
                        smooth_edges=cfg.smooth_edges)
        if cfg.confidence_mode:
            manifest.update(rmsd_classification_cutoff=2.0, num_prot_emb_layers=0, reduce_pseudoscalars=False,
                            crop_beyond=20.0)
        (src / "model_parameters.yml").write_text(yaml_io.dump(manifest))
        dirs[name] = str(tmp_path / name)
        convert.main(["--checkpoint", str(src / "model.pt"), "--out_dir", dirs[name], "--old_score_model"])
    m = infer.main(["--data_dir", files["data"], "--samples_per_complex", "2", "--inference_steps", "2",
                    "--model_dir", dirs["score"], "--confidence_model_dir", dirs["conf"], "--old_score_model",
                    "--out_dir", str(tmp_path / "run"), "--device", "cpu"])
    assert m["failures"] == 0 and np.isfinite(m["rmsds_below_2"])


def test_unported_flags_and_devices_raise(files, tmp_path):
    base = ["--data_dir", files["data"], "--out_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 8"):
        infer.main(base + ["--data_parallel"])
    with pytest.raises(SystemExit, match="modern architecture"):  # --old_score_model on a modern checkpoint
        infer.main(base + ["--old_score_model", "--model_dir", files["score"]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(base[:-2])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dock.main(dock_argv(files, tmp_path)[:-2])
    with pytest.raises(RuntimeError, match="esm"):
        dock.main(["--protein_sequence", "MKT", "--ligand", "CCO", "--out_dir", str(tmp_path), "--device", "cpu"])


def test_dock_and_infer_with_an_all_atom_score_model(files, tmp_path, monkeypatch):
    """A model directory of the all-atom model in score mode (lmax=2, the
    ns=8 tiny widths) beside the all-atom confidence model: the CLIs
    featurize receptor atoms because the confidence model is all-atom (as
    the JAX CLIs decide it), sample with no phase plan and rerank."""
    install_jax_tables(monkeypatch)
    cfg = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0, all_atoms=True,
                           sh_lmax=2)
    save_model_dir(str(tmp_path / "aa_score"), cfg, get_model(cfg, device="cpu", seed=4))
    argv = dock_argv(files, tmp_path / "dock", "--samples", "2", "--inference_steps", "2")
    argv[argv.index("--model_dir") + 1] = str(tmp_path / "aa_score")
    pos, conf = dock.main(argv)
    assert pos.shape[0] == 2 and np.isfinite(pos).all() and np.isfinite(conf).all()
    m = infer.main(["--data_dir", files["eval_data"], "--samples_per_complex", "2", "--inference_steps", "2",
                    "--model_dir", str(tmp_path / "aa_score"), "--confidence_model_dir", files["conf"],
                    "--limit_complexes", "1", "--out_dir", str(tmp_path / "run"), "--device", "cpu"])
    assert m["failures"] == 0 and np.isfinite(m["rmsds_below_2"])
