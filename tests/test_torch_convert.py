"""The port's reference-checkpoint converter against the JAX package's.

A reference-layout state dict is made from each of the four architectures
(the score model, the all-atom confidence model and both legacy models, at
small widths; seeded weights with random batch-norm statistics) by
``chip_smoke.reference_state_dict``, held exactly against the JAX tests'
inverse maps (``tests/test_convert.py``) where they have one. Both
packages' ``convert_state_dict`` turn it into the same Flax tree, bit for
bit, equal to the model's own variables; the port's forward on it is within
2e-4 x max(1, max |jax|) of the JAX model's. Both convert CLIs write the same
``model_config.yml`` text and msgpack bytes from one ``.pt`` in each of the
reference's three layouts and with ``--use_ema``; legacy model directories
written by either package load in the other.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from confidence_bootstrapping_tpu.cli import convert as jconvert_cli
from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.models import convert as jconvert
from confidence_bootstrapping_tpu.models.factory import confidence_model_config as jax_confidence_config
from confidence_bootstrapping_tpu.models.factory import get_model as jax_get_model
from confidence_bootstrapping_tpu.train import checkpoints as jcheckpoints
from confidence_bootstrapping_tpu_torch import yaml_io
from confidence_bootstrapping_tpu_torch.cli import convert as convert_cli
from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, confidence_model_config
from confidence_bootstrapping_tpu_torch.models import convert, factory, from_flax
from test_convert import _fake_legacy_sd, _fake_sd_from_params
from test_torch_common import both_batches, install_jax_score_norms, padded_1a0q, perturbed_pose, randomize_stats
from test_torch_confidence import CONFIGS as AA_CONFIGS
from test_torch_confidence import small_complex
import test_torch_legacy as tl

REL = 2e-4
ARCHS = {
    "score": dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0, dropout=0.0),
    "all_atom": None,  # the confidence architecture at test_torch_confidence's "default" widths
    "legacy_score": tl.CASES["score"],
    "legacy_all_atom": tl.CASES["affinity"],
}


def _cfgs(arch: str):
    if arch == "all_atom":
        kw = dict(AA_CONFIGS["default"], dropout=0.0)
        return jax_confidence_config(**kw), confidence_model_config(**kw)
    return JaxScoreConfig(**ARCHS[arch]), ScoreModelConfig(**ARCHS[arch])


@functools.lru_cache(maxsize=None)
def _case(arch: str):
    """(port model, its Flax variables, reference state dict); the legacy
    ones are test_torch_legacy's models."""
    if arch.startswith("legacy"):
        _, variables, model = tl._models("score" if arch == "legacy_score" else "affinity")
    else:
        model = factory.get_model(_cfgs(arch)[1], device="cpu", seed=11)
        variables = randomize_stats(from_flax.flax_from_state_dict(model), seed=4)
        from_flax.load_flax_variables(model, variables)
    return model, variables, chip_smoke.reference_state_dict(model)


def _same_tree(a: dict, b: dict, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if not isinstance(a, dict):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
        return
    assert sorted(a) == sorted(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        _same_tree(a[k], b[k], f"{path}/{k}")


def _group_map(cfg):
    """The legacy conv layers' Flax names -> reference prefixes (as
    tests/test_convert.py builds them)."""
    out = {}
    for i in range(cfg.num_conv_layers):
        if cfg.all_atoms:
            for g in range(3 if i == cfg.num_conv_layers - 1 else 9):
                out[f"{jconvert._LEGACY_AA_GROUPS[g]}_{i}"] = f"conv_layers.{9 * i + g}"
        else:
            groups = ("lig_conv_layers", "rec_to_lig_conv_layers")
            if i < cfg.num_conv_layers - 1:
                groups += ("rec_conv_layers", "lig_to_rec_conv_layers")
            out.update({f"{g}_{i}": f"{g}.{i}" for g in groups})
    return out


@pytest.mark.parametrize("arch", ["score", "legacy_score", "legacy_all_atom"])
def test_inverse_map_equals_the_jax_tests(arch):
    """chip_smoke's inverse map against tests/test_convert.py's, key for key
    and bit for bit (the all-atom confidence architecture has no importable
    one there; its map is held by the round trip below)."""
    model, variables, sd = _case(arch)
    jcfg = _cfgs(arch)[0]
    want = (_fake_sd_from_params(jcfg, variables) if arch == "score"
            else _fake_legacy_sd(jcfg, variables, _group_map(jcfg)))
    assert sorted(sd) == sorted(want)
    for k in want:
        assert np.asarray(sd[k]).tobytes() == np.asarray(want[k]).tobytes(), k


def _jax_forward(arch: str, tree: dict) -> dict:
    """The JAX model's outputs on the arch's batch with ``tree``."""
    if arch.startswith("legacy"):
        return tl.jax_outputs("score" if arch == "legacy_score" else "affinity")
    jcfg = _cfgs(arch)[0]
    out = jax.jit(jax_get_model(jcfg).apply)(tree, _batch(arch)[0])
    return {n: np.asarray(getattr(out, n)) for n in (("confidence",) if jcfg.confidence_mode
                                                     else ("tr_pred", "rot_pred", "tor_pred"))}


def _batch(arch: str):
    if arch.startswith("legacy"):
        key = "score" if arch == "legacy_score" else "affinity"
        return tl._batches(tl.CASES[key], tl.batch_size(key))
    padded = small_complex()[0] if arch == "all_atom" else padded_1a0q(0)
    return both_batches(padded, 2, lig_pos=perturbed_pose(padded, 2, seed=3, scale=1.0),
                        t=0.0 if arch == "all_atom" else 0.4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_convert_state_dict_matches_jax(arch, monkeypatch):
    """Both converters give the same tree bit for bit (in each of the three
    layouts), the model's own variables; the port's forward on it against
    the JAX model's."""
    install_jax_score_norms(monkeypatch)
    model, variables, sd = _case(arch)
    jcfg, cfg = _cfgs(arch)
    for layout in (sd, {"epoch": 2, "model": sd, "optimizer": {}}, {f"module.{k}": v for k, v in sd.items()}):
        got = convert.convert_state_dict(layout, cfg)
        _same_tree(got, jconvert.convert_state_dict(layout, jcfg))
    _same_tree(got, variables)
    fresh = from_flax.load_flax_variables(factory.get_model(cfg, device="cpu", seed=99), got)
    want, out = _jax_forward(arch, got), fresh(_batch(arch)[1])
    for n, w in want.items():
        np.testing.assert_allclose(getattr(out, n).numpy(), w, rtol=0, atol=REL * max(1.0, float(np.abs(w).max())),
                                   err_msg=n)


def test_permutations_match_jax():
    """The e3nn sort orders and TP-weight permutations on drawn irreps, and
    each layer kind of tp_perm_for_layer."""
    rng = np.random.RandomState(0)
    blocks = ["0e", "0o", "1o", "1e"]
    shs = ["1x0e + 1x1o", "1x0e + 1x1o + 1x2e", "1x2e + 1x1o + 1x2o + 1x3o"]
    for _ in range(12):
        irr = lambda: " + ".join(f"{rng.randint(1, 4)}x{b}" for b in rng.choice(blocks, rng.randint(1, 4), False))
        i, o, sh = irr(), irr(), shs[rng.randint(3)]
        try:
            want = jconvert.e3nn_tp_weight_permutation(i, sh, o, sh_sorted=sh == shs[2])
        except ValueError:
            continue
        got = convert.e3nn_tp_weight_permutation(i, sh, o, sh_sorted=sh == shs[2])
        assert (got is None and want is None) or np.array_equal(got, want), (i, sh, o)
        assert convert.e3nn_sorted_irreps(i) == [tuple(x) for x in jconvert.e3nn_sorted_irreps(i)]
        assert convert.e3nn_sh_sort_order(sh) == jconvert.e3nn_sh_sort_order(sh)
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        seq = ["8x0e", "8x0e + 2x1o + 2x1e + 8x0o"]
        for kind in ("trunk", "final", "tor"):
            for generic in (False, True):
                a = convert.tp_perm_for_layer(cfg, seq[0], seq[1], kind, generic)
                b = jconvert.tp_perm_for_layer(jcfg, seq[0], seq[1], kind, generic)
                assert (a is None and b is None) or np.array_equal(a, b)


def _manifest_and_files(tmp_path, legacy: bool):
    """A reference manifest and the state dict as .pt files in the three
    layouts (the bundle with EMA weights, parameters() order)."""
    keys = dict(ARCHS["legacy_score"], lm_embedding_dim=0) if legacy else dict(ARCHS["score"])
    model = (factory.get_model(ScoreModelConfig(**keys), device="cpu", seed=5) if legacy else _case("score")[0])
    sd = chip_smoke.reference_state_dict(model)
    keys.pop("old_score_model", None)
    keys.pop("lm_embedding_dim")  # no ESM path in the manifest: lm_embedding_dim 0
    manifest = dict(keys, esm_embeddings_path=None)
    (tmp_path / "model_parameters.yml").write_text(yaml_io.dump(manifest))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    params = [k for k in t if not k.endswith(convert_cli.BUFFERS)]
    files = {
        "raw": t,
        "bundle": {"epoch": 3, "model": t, "optimizer": {}, "ema_weights": {"shadow_params": [t[k] * 0.5 for k in params]}},
        "module": {f"module.{k}": v for k, v in t.items()},
    }
    for name, obj in files.items():
        torch.save(obj, str(tmp_path / f"{name}.pt"))
    return model


def test_convert_clis_write_the_same_files(tmp_path):
    _manifest_and_files(tmp_path, legacy=False)
    runs = [("raw", []), ("bundle", []), ("module", []), ("bundle", ["--use_ema"])]
    outs = set()
    for name, extra in runs:
        a, b = tmp_path / f"jax_{name}{len(extra)}", tmp_path / f"port_{name}{len(extra)}"
        args = ["--checkpoint", str(tmp_path / f"{name}.pt")] + extra
        jconvert_cli.main(args + ["--out_dir", str(a)])
        convert_cli.main(args + ["--out_dir", str(b)])
        for f in ("model_config.yml", "last_model.msgpack"):
            assert (a / f).read_bytes() == (b / f).read_bytes(), (name, extra, f)
        outs.add((b / "last_model.msgpack").read_bytes())
    assert len(outs) == 2  # the three layouts agree; the EMA weights differ


def test_legacy_model_directories_cross_load(tmp_path):
    """A legacy directory the port's CLI writes (``--old_score_model``) loads
    in the JAX package with the same values; one the JAX package writes
    loads in the port with the same values."""
    model = _manifest_and_files(tmp_path, legacy=True)
    out = tmp_path / "port_dir"
    convert_cli.main(["--checkpoint", str(tmp_path / "raw.pt"), "--out_dir", str(out), "--old_score_model"])
    jcfg = JaxScoreConfig(**dict(ARCHS["legacy_score"], lm_embedding_dim=0))
    template = jax.tree.map(np.zeros_like, from_flax.flax_from_state_dict(model))
    got_cfg, got = jcheckpoints.load_model_dir(str(out), template)
    assert got_cfg.old_score_model and got_cfg.ns == jcfg.ns
    _same_tree(jax.tree.map(np.asarray, got), from_flax.flax_from_state_dict(model))

    jdir = tmp_path / "jax_dir"
    jcheckpoints.save_model_dir(str(jdir), jcfg, from_flax.flax_from_state_dict(model))
    ported, cfg = load_or_init_model(str(jdir), "last_model", device="cpu")
    assert cfg.old_score_model and type(ported) is type(model)
    _same_tree(from_flax.flax_from_state_dict(ported), from_flax.flax_from_state_dict(model))
