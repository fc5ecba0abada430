"""The port's scale gates at CPU size (``scripts/stress_eval_torch.py``,
``scripts/esm_scale_check_torch.py``, ``scripts/cb_scale_run_torch.py``).

The full runs go on the card and commit ``docs/artifacts/*_h100.json``.
Here: the synthetic complexes are the JAX harness's bytes, the size plan is
the JAX harness's, and each harness's ``--smoke --device cpu`` run
completes and writes an artifact with the JAX artifact's keys plus
``card`` and ``device``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from test_torch_common import install_jax_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import cb_scale_run_torch  # noqa: E402
import esm_scale_check_torch  # noqa: E402
import stress_eval  # noqa: E402
import stress_eval_torch  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")


def jax_keys(name: str) -> set:
    with open(os.path.join(ARTIFACTS, name)) as f:
        return set(json.load(f))


@pytest.mark.parametrize("seed,n_res,n_lig", [(0, 50, 12), (1, 131, 20), (2, 307, 24)])
def test_write_complex_writes_the_jax_bytes(tmp_path, seed, n_res, n_lig):
    name = f"stress{seed:03d}"
    stress_eval.write_complex(str(tmp_path / "jax"), name, n_res, n_lig, seed)
    stress_eval_torch.write_complex(str(tmp_path / "port"), name, n_res, n_lig, seed)
    for suffix in ("protein_processed.pdb", "ligand.sdf"):
        a = (tmp_path / "jax" / name / f"{name}_{suffix}").read_bytes()
        b = (tmp_path / "port" / name / f"{name}_{suffix}").read_bytes()
        assert a == b, suffix


def test_size_plan_is_the_jax_plan():
    """The JAX harness draws the sizes of every complex, then each
    ligand's atoms as it writes the complexes (``stress_eval.py:main``)."""
    rng = np.random.RandomState(0)
    sizes = [int(rng.randint(*[(600, 1000), (1100, 1900), (2100, 2900)][i % 3])) for i in range(85)]
    want = [(s, int(rng.randint(20, 25))) for s in sizes]
    got = stress_eval_torch.size_plan(85)
    assert got == want
    buckets = {stress_eval_torch.receptor_bucket(s) for s, _ in got}
    assert buckets <= {768, 1024, 1536, 2048, 3072} and {1024, 2048, 3072} <= buckets


def test_stress_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "stress.json"
    stress_eval_torch.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "w"), "--out", str(out)])
    art = json.loads(out.read_text())
    assert jax_keys("stress_dockgen_scale.json") | {"card", "device"} <= set(art)
    assert art["n_complexes"] == 3 and art["failures"] == 0 and all(art["gates"].values())
    assert art["device"] == "cpu" and art["backend"] == "cpu"
    # the generator's contract: protein-like extent, the ligand's atoms as written
    from confidence_bootstrapping_tpu_torch.data import featurize, mol_io

    d = tmp_path / "w" / "data" / "stress001"
    hc = featurize.build_host_complex("stress001", mol_io.read_molecule(str(d / "stress001_ligand.sdf")),
                                      mol_io.parse_pdb(str(d / "stress001_protein_processed.pdb")))
    assert len(hc.rec_f) == 90 and len(hc.lig_f) == 12
    assert 15.0 < np.ptp(np.asarray(hc.rec_pos), axis=0).max() < 80.0
    assert sum(art["per_bucket_n"].values()) == 3


def test_esm_scale_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "esm.json"
    esm_scale_check_torch.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "w"), "--out", str(out)])
    art = json.loads(out.read_text())
    assert jax_keys("esm_scale_tpu.json") | {"card", "device"} <= set(art)
    assert art["finite"] and art["bucket_N"] == 256 and art["poses_per_s"] > 0


def test_cb_scale_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "cb.json"
    cb_scale_run_torch.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "w"), "--out", str(out)])
    art = json.loads(out.read_text())
    # the keys scripts/cb_scale_run.py writes (its artifact is not committed)
    assert {"targets", "lm_dim", "samples_per_rollout", "inference_steps", "total_wall_s", "epochs", "card",
            "device"} <= set(art)
    assert art["ok"] and len(art["epochs"]) == 2
    assert all(e["failures"] == 0 and e["n_sampled"] == 4 for e in art["epochs"])
    assert [t[0] for t in art["targets"]] == ["1a0q", "cbsyn00"]
