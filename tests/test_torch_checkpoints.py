"""Model directories in the port against the JAX package and flax.

* The msgpack codec (``train/flax_msgpack.py``) against flax 0.12's
  ``msgpack_serialize``/``msgpack_restore``: the same bytes, each side reads
  the other's, on trees of nested str-keyed dicts of float32, float64,
  int32, int64, uint8 and bool arrays (0-d and empty ones too) and Python
  and numpy scalars, and with arrays split into chunks (``MAX_CHUNK_SIZE``
  made small on both sides).
* Model directories both ways: the JAX package's ``save_model_dir`` read by
  the port's ``cli.dock.load_or_init_model`` on the CPU (the forward within
  2e-4 x max(1, max |jax|) of the JAX model's), and the port's
  ``save_model_dir`` read by the JAX package's ``load_model_dir`` against its
  template (the arrays exactly equal, the configs equal); a small score
  model (ns=8, nv=2, 2 trunk layers, 1 protein-embedding layer, no language
  model features, as tests/test_convert.py's manifest) and a small lmax=2
  confidence model. ``flax_from_state_dict`` inverts the bridge exactly.
* The config yaml (``yaml_io``) against PyYAML: the defaults' text equal to
  ``yaml.safe_dump``'s; each side reads the other's text to the same data,
  for drawn field values too; the refused constructs name their line.
* The factory: every field the port does not implement is refused by name
  (``sh_lmax >= 3``), the fields refused before the port had them build a
  model whose forward is finite, and ``config_from_reference_manifest``
  equals the JAX one.
* No module of the port imports jax, flax, msgpack, yaml or the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import flax.serialization
import jax
import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

from confidence_bootstrapping_tpu import config as jconfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models import all_atom_model as jaam
from confidence_bootstrapping_tpu.models import factory as jfactory
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxScoreModel
from confidence_bootstrapping_tpu.train import checkpoints as jcheckpoints
from confidence_bootstrapping_tpu_torch import config, yaml_io
from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model, peek_model_config
from confidence_bootstrapping_tpu_torch.models import factory, from_flax, legacy
from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.train import checkpoints, flax_msgpack
from test_torch_common import ROOT, both_batches, install_jax_score_norms, padded_1a0q, perturbed_pose, port_batch, randomize_stats

REL = 2e-4
# tests/test_convert.py's reference-style manifest of a small score model
SCORE_MANIFEST = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, dropout=0.0, esm_embeddings_path=None)
SMALL_CONF = dict(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=16, crop_beyond=7.0, crop_res_cap=16,
                  crop_atom_cap=120, dropout=0.0)
FEW = settings(max_examples=12, deadline=None, database=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0, atol=rel * scale)


def _same_tree(a, b, path="") -> None:
    """Exactly the same tree: keys, leaf types, dtypes, shapes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b) if isinstance(b, dict) else b)
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else (tree.dtype, tree.shape)


# ----------------------------------------------------------------------------- the msgpack codec

_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_)


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    return (rng.randn(*shape) * 100).astype(dtype) if shape else np.asarray(rng.randn() * 100).astype(dtype)


_leaves = st.one_of(
    _arrays(), st.none(), st.booleans(), st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=False),
    st.text(max_size=40), st.binary(max_size=40),
    st.sampled_from(_DTYPES).map(lambda t: t(3)),  # numpy scalars
)
_trees = st.recursive(_leaves, lambda kids: st.dictionaries(st.text(min_size=1, max_size=12), kids, max_size=5),
                      max_leaves=20).filter(lambda t: isinstance(t, dict))


@FEW
@given(_trees)
def test_msgpack_codec_matches_flax(tree):
    """flax's ``to_bytes`` keeps the dicts' order, ``msgpack_serialize``
    sorts their keys (``jax.tree_util``): the port's bytes equal the first,
    and each side reads the other's to the tree."""
    ours = flax_msgpack.to_bytes(tree)
    assert ours == flax.serialization.to_bytes(tree)
    _same_tree(flax_msgpack.restore(flax.serialization.msgpack_serialize(tree)), tree)
    _same_tree(flax.serialization.msgpack_restore(ours), tree)
    _same_tree(flax_msgpack.restore(ours), tree)


def test_msgpack_chunked_arrays_match_flax(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes go in flat chunks on both sides."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(0)
    tree = {"params": {"w": rng.randn(7, 5).astype(np.float32), "small": np.arange(3, dtype=np.int64)},
            "big": rng.randint(0, 255, (3, 50)).astype(np.uint8)}
    theirs = flax.serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == theirs
    got = flax_msgpack.restore(theirs)
    for k, v in (("w", tree["params"]["w"]), ("small", tree["params"]["small"])):
        np.testing.assert_array_equal(got["params"][k], v)
        assert got["params"][k].dtype == v.dtype
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_msgpack_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.restore(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="after the end"):
        flax_msgpack.restore(flax_msgpack.to_bytes({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        flax_msgpack.restore(flax_msgpack.to_bytes({"a": np.zeros(4, np.float32)})[:-3])
    with pytest.raises(TypeError):
        flax_msgpack.to_bytes({"c": 1 + 2j})


# ----------------------------------------------------------------------------- model directories both ways


@functools.lru_cache(maxsize=None)
def _score_setup():
    """(JAX config, JAX model, its variables with random batch statistics,
    the JAX batch, the port's batch) of the small score model on 1a0q."""
    jcfg = jfactory.config_from_reference_manifest(SCORE_MANIFEST)
    padded = padded_1a0q(0)
    jb, tb = both_batches(padded, 2, lig_pos=perturbed_pose(padded, 2), t=0.6)
    jmodel = JaxScoreModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb), seed=2)
    return jcfg, jmodel, variables, jb, tb


@functools.lru_cache(maxsize=None)
def _confidence_setup():
    """The same for the small lmax=2 confidence model on the small all-atom
    complex of tests/test_torch_confidence.py."""
    from confidence_bootstrapping_tpu.data import complex_graph as jcg
    from test_torch_confidence import small_complex

    jcfg = jfactory.confidence_model_config(**SMALL_CONF)
    padded, _ = small_complex()
    jb = jcg.replicate_complex(padded, 2)
    jb = jb.replace(lig_pos=jax.numpy.asarray(perturbed_pose(padded, 2, seed=4))).set_time(0.0, 0.0, 0.0)
    jmodel = jaam.AllAtomScoreModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jb), seed=3)
    return jcfg, jmodel, variables, jb, port_batch(jb)


def _outputs(kind, out):
    return [out.confidence] if kind == "confidence" else [out.tr_pred, out.rot_pred, out.tor_pred]


@pytest.mark.parametrize("kind", ["score", "confidence"])
def test_port_reads_a_model_dir_the_jax_package_wrote(kind, tmp_path, monkeypatch, capsys):
    install_jax_score_norms(monkeypatch)
    jcfg, jmodel, variables, jb, tb = _score_setup() if kind == "score" else _confidence_setup()
    jcheckpoints.save_model_dir(str(tmp_path), jcfg, variables)
    model, cfg = load_or_init_model(str(tmp_path), "last_model", device="cpu")
    assert "loaded weights" in capsys.readouterr().out
    assert config.to_dict(cfg) == jconfig.to_dict(jcfg)
    assert isinstance(model, AllAtomScoreModel if kind == "confidence" else TensorProductScoreModel)
    want, got = jax.jit(jmodel.apply)(variables, jb), model(tb)
    for g, w in zip(_outputs(kind, got), _outputs(kind, want)):
        _close(g, w)
    _same_tree(from_flax.flax_from_state_dict(model), jax.tree.map(np.asarray, variables))
    # the port writes the bytes the JAX package writes for the same weights
    checkpoints.save_params(str(tmp_path / "port.msgpack"), model)
    with open(tmp_path / "port.msgpack", "rb") as f, open(tmp_path / "last_model.msgpack", "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kind", ["score", "confidence"])
def test_jax_package_reads_a_model_dir_the_port_wrote(kind, tmp_path):
    jcfg, jmodel, variables, _, _ = _score_setup() if kind == "score" else _confidence_setup()
    cfg = config.from_dict(config.ScoreModelConfig, jconfig.to_dict(jcfg))
    model = factory.get_model(cfg, device="cpu", seed=5)
    checkpoints.save_model_dir(str(tmp_path), cfg, model)
    got_cfg, got = jcheckpoints.load_model_dir(str(tmp_path), variables)
    assert got_cfg == jcfg
    ours = from_flax.flax_from_state_dict(model)
    _same_tree(jax.tree.map(np.asarray, got), ours)
    assert _shapes(jax.tree.map(np.asarray, variables)) == _shapes(ours)  # the template's keys and shapes
    # and the port reads its own directory back bit for bit, into another seed's model
    back_cfg, back = checkpoints.load_model_dir(str(tmp_path), factory.get_model(cfg, device="cpu", seed=9))
    assert back_cfg == cfg
    _same_tree(from_flax.flax_from_state_dict(back), ours)


def test_load_params_is_strict(tmp_path):
    """A bundle with a missing key, an extra key or another shape raises and
    names the key; a directory with no checkpoint keeps the seeded weights."""
    jcfg, _, variables, _, _ = _score_setup()
    cfg = config.from_dict(config.ScoreModelConfig, jconfig.to_dict(jcfg))
    model = factory.get_model(cfg, device="cpu", seed=0)
    tree = from_flax.flax_from_state_dict(model)
    path = str(tmp_path / "w.msgpack")

    def write(t):
        with open(path, "wb") as f:
            f.write(flax_msgpack.to_bytes(t))

    missing = jax.tree.map(lambda x: x, tree)
    del missing["params"]["tr_final_layer"]["Dense_1"]["bias"]
    write(missing)
    with pytest.raises(ValueError, match=r"tr_final_layer\.layers\.1\.bias"):
        checkpoints.load_params(path, model)
    extra = jax.tree.map(lambda x: x, tree)
    extra["params"]["tr_final_layer"]["Dense_2"] = {"bias": np.zeros(3, np.float32)}
    write(extra)
    with pytest.raises(ValueError, match=r"tr_final_layer\.layers\.2\.bias"):
        checkpoints.load_params(path, model)
    shaped = jax.tree.map(lambda x: x, tree)
    shaped["params"]["tr_final_layer"]["Dense_0"]["kernel"] = np.zeros((3, 3), np.float32)
    write(shaped)
    with pytest.raises(ValueError, match=r"tr_final_layer\.layers\.0\.weight"):
        checkpoints.load_params(path, model)
    write(dict(tree, intermediates={"x": np.zeros(1, np.float32)}))
    with pytest.raises(ValueError, match="intermediates"):
        checkpoints.load_params(path, model)
    config.save_yaml(cfg, str(tmp_path / checkpoints.CONFIG_NAME))
    seeded, _ = load_or_init_model(str(tmp_path), "last_model", device="cpu", seed=7)
    assert not checkpoints.has_checkpoint(str(tmp_path))
    _same_tree(from_flax.flax_from_state_dict(seeded),
               from_flax.flax_from_state_dict(factory.get_model(cfg, device="cpu", seed=7)))


# ----------------------------------------------------------------------------- the config yaml


@pytest.mark.parametrize("make", [lambda m: m.ScoreModelConfig(), lambda m: m.confidence_model_config()],
                         ids=["score", "confidence"])
def test_config_yaml_matches_pyyaml(make, tmp_path):
    cfg = make(config)
    jcfg = jconfig.ScoreModelConfig() if cfg == config.ScoreModelConfig() else jfactory.confidence_model_config()
    d = config.to_dict(cfg)
    assert d == jconfig.to_dict(jcfg) and list(d) == list(jconfig.to_dict(jcfg))  # the same 55 keys, in order
    theirs = yaml.safe_dump(d, sort_keys=True)
    assert yaml_io.dump(d) == theirs
    assert yaml.safe_load(yaml_io.dump(d)) == d
    assert yaml_io.load(theirs) == yaml.safe_load(theirs)
    config.save_yaml(cfg, str(tmp_path / "c.yml"))
    assert jconfig.load_score_config(str(tmp_path / "c.yml")) == jcfg
    jconfig.save_yaml(jcfg, str(tmp_path / "j.yml"))
    assert config.load_score_config(str(tmp_path / "j.yml")) == cfg


def _field_values(f):
    """A strategy for a ScoreModelConfig field's values, by its type."""
    t = str(f.type)
    if f.name == "sigma":
        return st.tuples(*[st.floats(0.001, 50.0)] * 6).map(lambda v: config.SigmaParams(*v))
    if t == "bool":
        return st.booleans()
    if t == "int":
        return st.integers(-10**6, 10**6)
    if t == "float":
        return st.one_of(st.floats(allow_nan=False), st.floats(-1e-3, 1e-3))
    if t == "Optional[float]":
        return st.one_of(st.none(), st.floats(allow_nan=False))
    return st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=30)


_configs = st.fixed_dictionaries({f.name: _field_values(f) for f in dataclasses.fields(config.ScoreModelConfig)})


@FEW
@given(_configs)
def test_config_yaml_round_trips_drawn_values(fields):
    cfg = config.ScoreModelConfig(**fields)
    d = config.to_dict(cfg)
    ours, theirs = yaml_io.dump(d), yaml.safe_dump(d, sort_keys=True)
    assert yaml.safe_load(ours) == d
    assert yaml_io.load(theirs) == yaml.safe_load(theirs)
    assert config.from_dict(config.ScoreModelConfig, yaml_io.load(ours)) == cfg


_ascii = st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=120)
_scalars = st.one_of(st.none(), st.booleans(), st.integers(-10**20, 10**20), st.floats(allow_nan=False), _ascii,
                     st.text(max_size=40))
_keys = st.text(st.characters(min_codepoint=32, max_codepoint=126), min_size=1, max_size=20)
_yaml_data = st.dictionaries(_keys, st.recursive(
    _scalars, lambda kids: st.dictionaries(_keys, kids, max_size=4) | st.lists(_scalars, max_size=4), max_leaves=12),
    max_size=5)


@FEW
@given(_yaml_data)
def test_yaml_matches_pyyaml_on_drawn_data(d):
    """Nested mappings and lists of scalars, strings long enough that PyYAML
    folds them and with characters it escapes: each side reads the other's
    text to the same data."""
    ours, theirs = yaml_io.dump(d), yaml.safe_dump(d, sort_keys=True)
    assert yaml.safe_load(ours) == d
    assert yaml_io.load(theirs) == yaml.safe_load(theirs)


@pytest.mark.parametrize("text,line,what", [
    ("ns: 8\nnv: 2\nsigma: &s {a: 1}\n", 3, "anchors"),
    ("ns: 8\nx: *s\n", 2, "aliases"),
    ("ns: 8\nnv: 2\ntemp: !!python/tuple [1, 2]\n", 3, "tags"),
    ("ns: 8\nnote: |\n  text\n", 2, "block scalars"),
    ("ns: 8\nnote: >\n  text\n", 2, "block scalars"),
    ("ns: 8\n---\nns: 9\n", 2, "one document"),
    ("ns: 8\n? complex\n: 1\n", 2, "complex keys"),
    ("%YAML 1.1\n---\nns: 8\n", 1, "directives"),
    ("ns: 8\ndate: 2001-12-14\n", 2, "timestamps"),
])
def test_yaml_reader_refuses_constructs_and_names_the_line(text, line, what):
    with pytest.raises(ValueError, match=f"line {line}: .*{what}"):
        yaml_io.load(text)


def test_yaml_reader_reads_reference_style_manifests():
    """An argparse dump as older PyYAML wrote it: flow lists, a long string
    folded over two lines, comments, quoted and YAML 1.1 scalars."""
    text = ("all_atoms: true\nbatch_size: 16\ncudnn: off  # a comment\nesm_embeddings_path: data/esm2_output/a/very/long"
            "/path/that/goes/past/eighty/columns\n  continued.pt\nrmsd_classification_cutoff: [2.0, 5]\nscale: 1e3\n"
            "tr_sigma_max: 19.0\nname: 'it''s'\nempty:\nlist:\n- 1\n- .inf\n# the end\n")
    assert yaml_io.load(text) == yaml.safe_load(text)


# ----------------------------------------------------------------------------- the factory

_REFUSED = [("old_score_model", True), ("separate_noise_schedule", True), ("use_old_atom_encoder", True),
            ("no_aminoacid_identities", True), ("smooth_edges", True), ("parallel", 4),
            ("use_second_order_repr", True), ("tp_weights_layers", 3), ("depthwise_convolution", True),
            ("sidechain_pred", True), ("affinity_prediction", True), ("fixed_center_conv", False),
            ("sh_lmax", 2), ("all_atoms", True), ("sh_lmax", 3)]


# what the port still refuses: harmonics of l >= 3 in the trunk (a later slice)
_STILL_REFUSED = {("sh_lmax", 3)}
# refused until the score-model remainder was ported
_REMAINDER = {"use_second_order_repr", "tp_weights_layers", "depthwise_convolution", "sidechain_pred",
              "fixed_center_conv", "sh_lmax", "all_atoms"}


@pytest.mark.parametrize("field,value", _REFUSED)
def test_get_model_refuses_fields_the_port_does_not_implement(field, value, monkeypatch):
    """A field the port does not implement is refused by name; the others,
    refused until the legacy models, the affinity heads and the score-model
    remainder were ported, build (the all-atom one in score mode) and run a
    finite forward on the CPU (the legacy knobs pass through the modern
    models, which do not read them, as in the JAX package)."""
    cfg = config.ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0,
                                  **{field: value})
    if (field, value) in _STILL_REFUSED:
        with pytest.raises(ValueError, match=rf"{field}={value!r}"):
            factory.get_model(cfg, device="cpu")
        return
    install_jax_score_norms(monkeypatch)
    model = factory.get_model(cfg, device="cpu")
    assert not factory.unsupported_fields(cfg)
    assert isinstance(model, {"old_score_model": legacy.OldTensorProductScoreModel,
                              "all_atoms": AllAtomScoreModel}.get(field, TensorProductScoreModel))
    if field in _REMAINDER:  # the small all-atom 1a0q complex (64 residues, 512 atoms)
        from test_torch_confidence import small_complex

        tb = port_batch(jcg.replicate_complex(small_complex()[0], 2).set_time(0.3, 0.3, 0.3))
    else:
        _, tb = both_batches(padded_1a0q(0), 2, t=0.3)
    assert all(torch.isfinite(t).all() for t in model(tb) if t is not None)


@pytest.mark.parametrize("field,value", [("confidence_mode", True), ("crop_beyond", 20.0)])
def test_get_model_builds_the_residue_level_confidence_mode_and_crop(field, value, monkeypatch):
    """The residue-level model's confidence mode and its crop mask, refused
    before the port had them: built, and a forward on the CPU is finite (in
    confidence mode the confidence heads, in score mode the score heads)."""
    install_jax_score_norms(monkeypatch)
    cfg = config.ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0,
                                  **{field: value})
    model = factory.get_model(cfg, device="cpu")
    assert isinstance(model, TensorProductScoreModel) and not factory.unsupported_fields(cfg)
    assert hasattr(model, "confidence_predictor") == (field == "confidence_mode")
    _, tb = both_batches(padded_1a0q(0), 2, t=0.3)
    out = model(tb)
    assert all(torch.isfinite(t).all() for t in out if t is not None)


def test_get_model_names_every_refused_field_and_builds_the_rest(tmp_path):
    cfg = config.ScoreModelConfig(ns=8, nv=2, sh_lmax=3, parallel=2, dropout=0.3,
                                  confidence_dropout=0.2, c_alpha_max_neighbors=10, parallel_aggregators="mean")
    with pytest.raises(ValueError) as err:
        factory.get_model(cfg, device="cpu")
    assert "sh_lmax=3" in str(err.value) and "parallel" not in str(err.value)  # parallel: ported
    ok = dataclasses.replace(cfg, sh_lmax=1, parallel=1, num_conv_layers=2, num_prot_emb_layers=1)
    assert isinstance(factory.get_model(ok, device="cpu"), TensorProductScoreModel)
    conf = config.confidence_model_config(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=0)
    assert isinstance(factory.get_model(conf, device="cpu"), AllAtomScoreModel)
    # a model_config.yml with a refused value fails loudly when loaded
    config.save_yaml(dataclasses.replace(ok, sh_lmax=3), str(tmp_path / checkpoints.CONFIG_NAME))
    with pytest.raises(ValueError, match="sh_lmax=3"):
        load_or_init_model(str(tmp_path), "last_model", device="cpu")


SCORE_REF = dict(  # a reference score-model manifest's model flags (argparse names)
    ns=32, nv=6, sh_lmax=1, num_conv_layers=5, num_prot_emb_layers=3, embed_also_ligand=True, dropout=0.1,
    max_radius=5.0, receptor_radius=15.0, cross_max_distance=80.0, dynamic_max_cross=True, embedding_type="sinusoidal",
    embedding_scale=1000, scale_by_sigma=True, no_batch_norm=False, not_fixed_center_conv=False,
    tr_sigma_min=0.1, tr_sigma_max=19.0, rot_sigma_min=0.03, rot_sigma_max=1.55, tor_sigma_min=0.0314,
    tor_sigma_max=3.14, esm_embeddings_path="data/esm2.pt", c_alpha_max_neighbors=24, lr=1e-3, batch_size=16)
CONF_REF = dict(  # and a confidence model's
    ns=24, nv=6, sh_lmax=2, num_conv_layers=5, num_prot_emb_layers=0, embed_also_ligand=False, all_atoms=True,
    rmsd_classification_cutoff=[2.0], atom_confidence_loss_weight=0.0, crop_beyond=20, embedding_scale=10000,
    reduce_pseudoscalars=False, moad_esm_embeddings_path="data/moad.pt", no_differentiate_convolutions=False)


@pytest.mark.parametrize("manifest", [SCORE_MANIFEST, {"ns": 16, "no_batch_norm": True}, SCORE_REF, CONF_REF,
                                      dict(CONF_REF, rmsd_classification_cutoff=[2.0, 5.0],
                                           atom_confidence_loss_weight=0.5)],
                         ids=["test_convert", "test_host_utils", "score", "confidence", "confidence_3way"])
def test_reference_manifest_translation_matches_jax(manifest, tmp_path):
    assert config.to_dict(factory.config_from_reference_manifest(manifest)) == \
        jconfig.to_dict(jfactory.config_from_reference_manifest(manifest))
    with open(tmp_path / "model_parameters.yml", "w") as f:
        yaml.safe_dump(manifest, f)
    assert config.to_dict(peek_model_config(str(tmp_path))) == \
        jconfig.to_dict(jfactory.config_from_reference_manifest(manifest))


def _manifest_values():
    fields = {f.name: f for f in dataclasses.fields(config.ScoreModelConfig)}
    flags = {src: _field_values(fields[dst]) for src, dst in factory._DIRECT.items()}
    flags.update({src: st.booleans() for src in factory._INVERTED})
    flags.update({p: st.floats(0.01, 20.0) for p in factory._SIGMAS})
    flags.update(esm_embeddings_path=st.sampled_from([None, "", "data/esm.pt"]),
                 rmsd_classification_cutoff=st.one_of(st.none(), st.floats(0.5, 5), st.lists(st.floats(0.5, 5), max_size=3)),
                 atom_confidence_loss_weight=st.sampled_from([None, 0.0, 0.3]), confidence_mode=st.booleans(),
                 unknown_flag=st.integers())
    return st.dictionaries(st.sampled_from(sorted(flags)), st.none(), max_size=12).flatmap(
        lambda keys: st.fixed_dictionaries({k: flags[k] for k in keys}))


@FEW
@given(_manifest_values())
def test_reference_manifest_translation_matches_jax_on_drawn_flags(manifest):
    assert factory._DIRECT == jfactory._DIRECT and factory._INVERTED == jfactory._INVERTED
    assert config.to_dict(factory.config_from_reference_manifest(manifest)) == \
        jconfig.to_dict(jfactory.config_from_reference_manifest(manifest))


# ----------------------------------------------------------------------------- imports


def test_the_port_imports_no_jax_flax_msgpack_or_yaml():
    """Every module of the port (and chip_smoke.py) imports in a process
    where importing jax, flax, msgpack, yaml, networkx (the card's machine
    has none) or the JAX package raises; the host data layer and the CLIs
    among them."""
    code = """
import importlib, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "msgpack", "yaml", "networkx", "confidence_bootstrapping_tpu"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import confidence_bootstrapping_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")] + ["chip_smoke"]
for n in names:
    importlib.import_module(n)
print(",".join(names), sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    names, loaded = out.stdout.split(" ", 1)
    names = names.split(",")
    assert len(names) >= 30 and loaded.strip() == "[]"
    assert {f"confidence_bootstrapping_tpu_torch.confidence.{m}" for m in ("dataset", "train")} <= set(names)
    assert {f"confidence_bootstrapping_tpu_torch.{m}" for m in (
        "data.mol_io", "data.parse_chi", "data.featurize", "data.conformers", "data.dataset", "data.moad",
        "data.esm_prep", "eval.relax", "cli.dock", "cli.infer", "models.legacy", "models.convert",
        "cli.convert")} <= set(names)
