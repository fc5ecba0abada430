"""The port's cross-cap A/B and phase-parity harnesses at CPU size
(``scripts/crosscap_ab_torch.py``, ``scripts/phase_parity_torch.py``).

The full runs go on the card and commit ``docs/artifacts/*_h100.json``.
Here: the caps the port's harness derives for each receptor bucket are the
JAX harness's (``scripts/crosscap_ab.py``: the forward arms at its lines
163-165, the rollout arms at 189-191), and the synthetic receptors land in
the N=1024/2048/3072 buckets; with the JAX model's weights carried over by
``models/from_flax``, the harness's forward at a cap below N (on and off the
16-grid) and at the uncapped cap equals the JAX model's ``apply`` at
``batch_norm=False`` within 2e-4 x max(1, max |jax|), the quantity the A/B
measures; each ``--smoke --device cpu`` run writes its artifact with the
JAX artifact's (or, for phase parity, the JAX script's printed) keys plus
``card`` and ``device``; ``scripts/crosscap_retrain_torch.py`` retraces the
cross-cap smoke run's training loss step for step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
from confidence_bootstrapping_tpu_torch.data.complex_graph import pick_bucket
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.factory import get_model
from test_torch_common import both_batches, install_jax_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import crosscap_ab_torch  # noqa: E402
import crosscap_retrain_torch  # noqa: E402
import phase_parity_torch  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")
JAX_PHASE_PARITY_KEYS = {"plan", "poses", "max_atom_dev", "mean_atom_dev", "rmsd_unphased", "rmsd_phased"}
TINY = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0, dropout=0.0, batch_norm=False,
            cross_cap_frac=0.0)


def jax_arms(caps, N):
    """The JAX harness's arms at bucket N, as its lines compute them."""
    scaled = int(round(N * 0.2))
    forward = [cap for cap in sorted(set(caps + [scaled])) if not cap >= N]
    roll_caps = [c for c in caps if c < N]
    roll_caps = sorted({roll_caps[0], roll_caps[-1], scaled}) if roll_caps else [scaled]
    return forward, roll_caps


@pytest.mark.parametrize("n_res,N", [(900, 1024), (1800, 2048), (2800, 3072)])
def test_arms_are_the_jax_arms(n_res, N):
    assert pick_bucket(22, 42, 0, n_res).N == N  # a write_complex receptor has n_res residues
    caps = [48, 96, 192]
    forward, rollout = jax_arms(caps, N)
    assert crosscap_ab_torch.forward_caps(caps, N) == forward
    assert crosscap_ab_torch.rollout_caps(caps, N) == rollout
    assert crosscap_ab_torch.scaled_cap(N) in forward and crosscap_ab_torch.scaled_cap(N) % 16  # off the 16-grid


def test_capped_forward_matches_jax(tmp_path, monkeypatch):
    """A 60-residue synthetic receptor (N=64): the uncapped cap (on the
    16-grid) and the scaled cap (off it), at t = 1 and 0."""
    install_jax_tables(monkeypatch)
    padded = crosscap_ab_torch.synthetic_complexes([60], str(tmp_path))[60]
    N = padded["rec_pos"].shape[0]
    jcfg = JaxScoreConfig(**TINY)
    jb0, _ = both_batches(padded, 2)
    variables = jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(0), jb0)
    model = get_model(ScoreModelConfig(**TINY), device="cpu")
    from_flax.load_flax_variables(model, variables)
    weights = model.state_dict()
    arms = crosscap_ab_torch.Arms(ScoreModelConfig(**TINY), "cpu")
    rng = np.random.RandomState(0)
    lig_pos = padded["lig_pos"][None] + rng.randn(2, 1, 3).astype(np.float32) * 2.0
    for cap in (N, crosscap_ab_torch.scaled_cap(N)):
        apply = jax.jit(JaxModel(dataclasses.replace(jcfg, cross_cap=cap)).apply)
        for t in (1.0, 0.0):
            jb, pb = both_batches(padded, 2, lig_pos=lig_pos, t=t)
            out = apply(variables, jb)
            want = [np.asarray(o) for o in (out.tr_pred, out.rot_pred, out.tor_pred)]
            got = arms.forward(weights, pb, cap, t)
            for head, g, w in zip(("tr", "rot", "tor"), got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * max(1.0, np.abs(w).max()),
                                           err_msg=f"cap {cap} t {t} {head}")


def test_crosscap_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "crosscap.json"
    crosscap_ab_torch.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "w"), "--out", str(out)])
    art = json.loads(out.read_text())
    with open(os.path.join(ARTIFACTS, "crosscap_ab_tpu.json")) as f:
        want = json.load(f)
    assert set(want) | {"card", "device", "launches", "route_check"} <= set(art)
    assert set(want["conclusion"]) <= set(art["conclusion"])
    assert art["device"] == "cpu" and art["backend"] == "cpu"
    N = 64
    assert sorted({k.split("/")[2] for k in art["forward_deviation"]}) == sorted(
        f"cap{c}" for c in crosscap_ab_torch.forward_caps([8, 16], N))
    assert set(art["rollout_divergence"]) == {f"N{N}/cap{c}" for c in crosscap_ab_torch.rollout_caps([8, 16], N)} | {
        f"N{N}/key_noise_floor"}
    assert set(art["route_check"]) == {f"N{N}/random_init/cap{N}", f"N{N}/random_init/cap13"}
    assert art["conclusion"]["rollout_same_seed_rerun_floor"][f"N{N}/same_seed_rerun"]["pose_rmsd_vs_uncapped_max"] == 0
    for row in art["route_check"].values():
        assert max(row["forward_rel_l2_kernels_vs_plain"].values()) == 0.0  # the CPU runs the plain versions
    # the cap's routes: cross_rev on the 16-grid, rows 4 and 6 off it
    assert "tpconv_cross_rev" in art["route_check"][f"N{N}/random_init/cap{N}"]["calls"]
    assert {"tpconv_cross", "tpconv_msgs"} <= set(art["route_check"][f"N{N}/random_init/cap13"]["calls"])
    assert len(art["train_loss"]) == art["train_steps_for_trained_weights"] and art["train_skipped_steps"] == 0
    assert set(art["conclusion"]["rollout_in_receptor"]) == {f"N{N}/uncapped"}
    # a second training from the same seed: on the CPU it retraces the harness's, to the artifact's 5 decimals
    again = crosscap_retrain_torch.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "w"), "--artifact",
                                         str(out)])
    assert again["first_step_apart"][1e-4] is None and again["skipped"] == 0
    assert {f"N{N}/{w}" for w in ("init", "ema", "last")} | {f"1a0q/{w}" for w in ("init", "ema", "last")} <= set(again)


def test_phase_parity_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "parity.json"
    phase_parity_torch.main(["--smoke", "--device", "cpu", "--plan", "1:256,2:128", "--plan", "2:128", "--out",
                             str(out)])
    art = json.loads(out.read_text())
    assert {"runs", "unphased_rerun_floor", "card", "device"} <= set(art) and art["device"] == "cpu"
    assert art["unphased_rerun_floor"]["max_atom_dev"] == 0.0  # the CPU's sample is deterministic
    assert [r["plan"] for r in art["runs"]] == ["1:256,2:128", "2:128"]
    for r in art["runs"]:
        assert JAX_PHASE_PARITY_KEYS <= set(r) and set(r["rmsd_phased"]) == {"mean", "min", "lt2"}
        assert np.isfinite(r["max_atom_dev"]) and r["rmsd_unphased"] == art["runs"][0]["rmsd_unphased"]
