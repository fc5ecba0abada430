"""The port's training remainder against the JAX package, on the CPU.

* ``CBConfig``: every field and default; ``TrainConfig``: the fields the
  port reads, in the JAX package's order (its other fields, which no loop
  reads, are not ported); the yaml round trip both ways (against PyYAML and
  the JAX package's reader).
* ``layer_freeze_mask``: the same 0/1 for every parameter at every step
  0..num_conv_layers+1, on the score model and on the all-atom confidence
  model (its MaskedBatchNorm1d and confidence head), decided on the Flax
  paths of ``models/from_flax``; exact.
* The masked update: gradients times the mask after the NaN zeroing and
  before ``clip_by_global_norm``, then Adam or AdamW on every parameter,
  against optax's chain (tests/test_torch_training.py's tolerance, rtol
  1e-6 / atol 1e-7); a whole-model step with the step-0 mask moves only the
  unfrozen parameters.
* ``AverageMeter``, ``PlateauScheduler``, ``train_epoch`` and ``test_epoch``
  against the JAX ones on the same metric streams.
* Train-state bundles: the port's file loads in the JAX package's
  ``load_train_state`` and the JAX package's in the port's, every leaf
  exact, the same bytes both ways; absent and corrupt bundles give
  (None, 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from confidence_bootstrapping_tpu import config as jconfig
from confidence_bootstrapping_tpu.train import checkpoints as jckpt, train_loop as jtl
from confidence_bootstrapping_tpu_torch import config, yaml_io
from confidence_bootstrapping_tpu_torch.models import all_atom_model as taam, from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.train import checkpoints, train_loop
from test_torch_common import assert_port_fields, both_batches, install_jax_tables, padded_1a0q, tiny_configs

# ----------------------------------------------------------------------------- configs


@pytest.mark.parametrize("name,kw", [("TrainConfig", {}), ("CBConfig", {}),
                                     ("TrainConfig", dict(w_decay=0.01, grad_clip=1.0, minimum_t=0.2)),
                                     ("CBConfig", dict(fixed_length=None, max_complexes_per_couple=None,
                                                       oracle_confidence=True, confidence_cutoff=-1.5, cb_cluster="x"))])
def test_train_and_cb_configs_match_jax_and_round_trip(name, kw, tmp_path):
    cfg, jcfg = getattr(config, name)(**kw), getattr(jconfig, name)(**kw)
    d = config.to_dict(cfg)
    assert_port_fields(d, jconfig.to_dict(jcfg), jconfig.to_dict(type(jcfg)()), every=name == "CBConfig")
    assert yaml_io.dump(d) == yaml.safe_dump(d, sort_keys=True)
    config.save_yaml(cfg, str(tmp_path / "port.yml"))
    assert jconfig.load_yaml(type(jcfg), str(tmp_path / "port.yml")) == jcfg
    jconfig.save_yaml(jcfg, str(tmp_path / "jax.yml"))
    assert config.load_yaml(type(cfg), str(tmp_path / "jax.yml")) == cfg


# ----------------------------------------------------------------------------- layer_freeze_mask


def _score_model():
    """The tiny score model (2 trunk layers) and its number of trunk layers."""
    tcfg = tiny_configs(0)[1]
    return TensorProductScoreModel(tcfg, device="cpu", seed=0), tcfg.num_conv_layers


def _confidence_model():
    """A small all-atom confidence model with an embedding layer (3 trunk layers)."""
    kw = dict(ns=8, nv=2, num_conv_layers=3, lm_embedding_dim=16, num_prot_emb_layers=1, embed_also_ligand=True)
    return taam.AllAtomScoreModel(config.confidence_model_config(**kw), device="cpu", seed=0), 3


@pytest.mark.parametrize("which", ["score", "confidence"])
def test_layer_freeze_mask_matches_jax_at_every_step(which):
    """The JAX mask of the port's weights (their Flax tree), carried back to
    parameter names, equals the port's mask at every step; the heads and
    batch norms train from step 0, the trunk unfreezes top-down, the rest
    after the last conv layer."""
    model, n_conv = _score_model() if which == "score" else _confidence_model()
    params = from_flax.flax_from_state_dict(model)["params"]
    seen = []
    for step in range(n_conv + 2):
        want = from_flax.state_dict_from_flax({"params": jtl.layer_freeze_mask(params, step)})
        got = train_loop.layer_freeze_mask(model, step)
        assert set(got) == set(want) == {n for n, _ in model.named_parameters()}
        assert all(bool((want[n] == got[n]).all()) for n in got), step  # empty parameters compare vacuously
        seen.append(sum(got.values()))
    assert seen == sorted(seen) and seen[0] > 0 and seen[-1] == len(got) and len(set(seen)) == n_conv + 2
    assert train_loop.layer_freeze_mask(model, 0)["conv_layers.0.bn.weight"] == 1.0
    assert train_loop.layer_freeze_mask(model, n_conv)["conv_layers.0.edge_mlps.0.layers.0.weight"] == 1.0


class _Named(torch.nn.Module):
    """Parameters named as a score model's (``conv_layers.<i>.edge_mlps.0``,
    a trunk batch norm, the ``tr_final_layer`` head, the
    ``lig_edge_embedding`` input) on small Linear layers."""

    def __init__(self, rng):
        super().__init__()

        def block(i, o):
            m = torch.nn.Module()
            m.layers = torch.nn.ModuleList([torch.nn.Linear(i, o)])
            return m

        self.conv_layers = torch.nn.ModuleList([torch.nn.Module(), torch.nn.Module()])
        for c in self.conv_layers:
            c.edge_mlps = torch.nn.ModuleList([block(3, 2)])
        self.conv_layers[1].bn = torch.nn.Module()
        self.conv_layers[1].bn.weight = torch.nn.Parameter(torch.ones(2))
        self.tr_final_layer = block(2, 3)
        self.lig_edge_embedding = block(4, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.as_tensor(rng.randn(*p.shape).astype(np.float32)))


@pytest.mark.parametrize("w_decay,grad_clip", [(0.0, None), (0.0, 0.5), (0.01, 0.5)])
def test_masked_update_matches_optax_chain(w_decay, grad_clip):
    """Four updates with the same gradients and masks (all of them, step 0's,
    step 1's, then a non-finite loss with step 2's), against the JAX step's
    arithmetic: NaN zeroing, g * mask, then ``optax.chain(clip, adam)``. A
    parameter masked after a step still moves by its moments (and decay)."""
    rng = np.random.RandomState(0)
    model = _Named(rng)
    cfg = config.TrainConfig(w_decay=w_decay, grad_clip=grad_clip)
    tx = jtl.make_optimizer(jconfig.TrainConfig(w_decay=w_decay, grad_clip=grad_clip))
    names = [n for n, _ in model.named_parameters()]
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    opt, ema = tx.init(params), params
    state = train_loop.init_train_state(model, cfg)
    masks = [None, train_loop.layer_freeze_mask(model, 0), train_loop.layer_freeze_mask(model, 1),
             train_loop.layer_freeze_mask(model, 2)]
    assert [masks[i]["conv_layers.0.edge_mlps.0.layers.0.weight"] for i in (1, 2, 3)] == [0.0, 0.0, 1.0]
    assert masks[1]["tr_final_layer.layers.0.bias"] == masks[1]["conv_layers.1.bn.weight"] == 1.0
    for step, (mask, ok) in enumerate(zip(masks, (True, True, True, False))):
        grads = {n: rng.randn(*params[n].shape).astype(np.float32) for n in names}
        if not ok:
            grads[names[0]].flat[0] = np.nan
        g = {n: jnp.where(ok, jnp.asarray(v), 0.0) * (1.0 if mask is None else mask[n]) for n, v in grads.items()}
        updates, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, updates)
        decay = min(cfg.ema_rate, (1 + step) / (10 + step))
        ema = jax.tree.map(lambda e, p: decay * e + (1 - decay) * p, ema, params)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        train_loop.apply_gradients(state, [torch.as_tensor(grads[n]) for n in names], torch.tensor(ok), cfg, mask)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-6, atol=1e-7, err_msg=n)
            np.testing.assert_allclose(state.ema[n].numpy(), np.asarray(ema[n]), rtol=1e-6, atol=1e-7, err_msg=n)
        if step == 1:  # frozen at step 0 after an unmasked step: still moves
            name = "lig_edge_embedding.layers.0.weight"
            assert masks[1][name] == 0.0 and not torch.equal(model.get_parameter(name), before[name])
    assert state.step == 4


def test_masked_whole_model_step_moves_only_what_is_unfrozen(monkeypatch):
    """The tiny score model's first step with the step-0 mask (Adam, no
    decay): the frozen parameters keep their values, the heads and batch
    norms move."""
    install_jax_tables(monkeypatch)
    model, _ = _score_model()
    _, tb = both_batches(padded_1a0q(0), 2)
    state = train_loop.init_train_state(model, config.TrainConfig())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mask = train_loop.layer_freeze_mask(model, 0)
    metrics = train_loop.make_train_step(model.cfg, config.TrainConfig())(state, tb, torch.Generator().manual_seed(0),
                                                                          grad_mask=mask)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    moved = {n: not torch.equal(p, before[n]) for n, p in model.named_parameters()}
    assert all(not moved[n] for n, m in mask.items() if m == 0.0)
    assert sum(moved[n] for n, m in mask.items() if m == 1.0) > 0.8 * sum(mask.values())


# ----------------------------------------------------------------------------- meters, scheduler, epochs


def _stream(seed, n=20):
    rng = np.random.RandomState(seed)
    return [({"loss": float(rng.randn()), "tr_loss": float(rng.rand())}, float(rng.rand())) for _ in range(n)]


@pytest.mark.parametrize("intervals", [1, 3, 10])
def test_average_meter_matches_jax(intervals):
    meters = [jtl.AverageMeter(intervals), train_loop.AverageMeter(intervals)]
    for metrics, t in _stream(intervals):
        for m in meters:
            m.add(metrics, t=t)
    want, got = meters[0].summary(), meters[1].summary()
    assert list(got) == list(want) and all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("goal,patience,factor", [("min", 2, 0.7), ("max", 0, 0.5), ("min", 5, 0.9)])
def test_plateau_scheduler_matches_jax(goal, patience, factor):
    """The same lr_scale after every epoch of one metric stream (JAX keeps
    it in float32)."""
    jstate = jtl.TrainState(params={}, batch_stats={}, opt_state=(), ema_params={}, step=jnp.zeros((), jnp.int32),
                            lr_scale=jnp.ones(()))
    state = train_loop.TrainState(model=None, optimizer=None, ema={})
    js, ts = jtl.PlateauScheduler(patience, factor, goal), train_loop.PlateauScheduler(patience, factor, goal)
    scales = []
    for metric in [3.0, 2.0, 2.5, 2.5, 2.6, 1.0, 1.5, 1.5, 1.7, 1.8, 1.9, 2.0, 0.5, 0.6, 0.7, 0.8]:
        jstate = js.step(jstate, metric)
        assert ts.step(state, metric) is state
        scales.append((float(state.lr_scale), float(jstate.lr_scale)))
        assert (ts.best, ts.bad_epochs) == (js.best, js.bad_epochs)
    np.testing.assert_allclose(*zip(*scales), rtol=1e-6)
    assert len({s for s, _ in scales}) > 1


def test_train_and_test_epoch_match_jax():
    """The epoch loops over stub steps: the same means (test_epoch pops t
    and buckets by it), the mask passed through to every step."""
    batches = [float(i) for i in range(7)]
    seen = []

    def jax_train(state, batch, key, grad_mask=None):
        seen.append(("jax", batch, grad_mask))
        return state, {"loss": jnp.asarray(batch * 0.5), "skipped": jnp.asarray(0.0)}

    def port_train(state, batch, generator, grad_mask=None):
        seen.append(("port", batch, grad_mask))
        return {"loss": torch.tensor(batch * 0.5), "skipped": torch.tensor(0.0)}

    for mask in (None, {"w": 0.0}):
        _, want = jtl.train_epoch(jax_train, None, batches, jax.random.PRNGKey(0), mask)
        state, got = train_loop.train_epoch(port_train, "state", batches, torch.Generator(), mask)
        assert state == "state" and got == want
    assert [s[1:] for s in seen if s[0] == "port"] == [s[1:] for s in seen if s[0] == "jax"]

    def jax_eval(state, batch, key):
        return {"loss": jnp.asarray(batch), "t": jnp.asarray(batch / 7.0)}

    def port_eval(state, batch, generator):
        return {"loss": torch.tensor(batch), "t": torch.tensor(batch / 7.0)}

    for intervals in (1, 4):
        want = jtl.test_epoch(jax_eval, None, batches, jax.random.PRNGKey(0), intervals)
        got = train_loop.test_epoch(port_eval, None, batches, torch.Generator(), intervals)
        assert got == want and "t" not in got


# ----------------------------------------------------------------------------- train-state bundles


def _trained_state(train_cfg, steps=2, seed=0):
    """The tiny score model's TrainState after ``steps`` updates with random
    gradients (Adam moments, EMA and step all away from their start), with
    random batch statistics and lr_scale 0.7."""
    _, tcfg = tiny_configs(0)
    model = TensorProductScoreModel(tcfg, device="cpu", seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for b in model.buffers():
            b.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
    state = train_loop.init_train_state(model, train_cfg)
    for _ in range(steps):
        grads = [torch.as_tensor(rng.randn(*p.shape).astype(np.float32)) for p in model.parameters()]
        train_loop.apply_gradients(state, grads, torch.tensor(True), train_cfg)
    state.lr_scale = 0.7
    return state


def _jax_template(state, jcfg):
    v = from_flax.flax_from_state_dict(state.model)
    return jtl.init_train_state(jax.tree.map(np.zeros_like, v), jcfg)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("w_decay,grad_clip", [(0.0, None), (0.01, None), (0.0, 1.0), (0.01, 1.0)])
def test_train_state_bundles_load_in_both_packages(w_decay, grad_clip, tmp_path):
    tcfg, jcfg = config.TrainConfig(w_decay=w_decay, grad_clip=grad_clip), \
        jconfig.TrainConfig(w_decay=w_decay, grad_clip=grad_clip)
    state = _trained_state(tcfg)
    checkpoints.save_train_state(str(tmp_path / "port"), state, epoch=5)
    jstate, epoch = jckpt.load_train_state(str(tmp_path / "port"), _jax_template(state, jcfg))
    assert epoch == 5 and int(jstate.step) == 2 and np.float32(jstate.lr_scale) == np.float32(0.7)
    # every leaf, against the port's values carried to Flax names
    want = jtl.TrainState(
        params=from_flax.flax_from_state_dict(state.model)["params"],
        batch_stats=from_flax.flax_from_state_dict(state.model)["batch_stats"],
        opt_state=None, ema_params=from_flax.flax_tree(state.model, state.ema), step=None, lr_scale=None)
    for field in ("params", "batch_stats", "ema_params"):
        got_l, want_l = _leaves(getattr(jstate, field)), _leaves(getattr(want, field))
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        assert all(np.array_equal(np.asarray(a), b) for (_, a), (_, b) in zip(got_l, want_l)), field
    adam = jstate.opt_state[1][0] if grad_clip else jstate.opt_state[0]
    assert int(adam.count) == 2
    for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        m = {n: state.optimizer.state[p][moment] for n, p in state.model.named_parameters()}
        want_l = _leaves(from_flax.flax_tree(state.model, m))
        got_l = _leaves(getattr(adam, key))
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        assert all(np.array_equal(np.asarray(a), b) for (_, a), (_, b) in zip(got_l, want_l)), key

    # the JAX package writes what it read: the same bytes; the port reads it back exactly
    jckpt.save_train_state(str(tmp_path / "jax"), jstate, epoch=5)
    assert (tmp_path / "jax" / "last_state.msgpack").read_bytes() == (tmp_path / "port" / "last_state.msgpack").read_bytes()
    fresh = train_loop.init_train_state(TensorProductScoreModel(tiny_configs(0)[1], device="cpu", seed=9), tcfg)
    got, epoch = checkpoints.load_train_state(str(tmp_path / "jax"), fresh)
    assert got is fresh and epoch == 5 and got.step == 2 and np.float32(got.lr_scale) == np.float32(0.7)
    for (n, a), (_, b) in zip(state.model.state_dict().items(), got.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, p in state.model.named_parameters():
        q = got.model.get_parameter(n)
        assert torch.equal(state.ema[n], got.ema[n])
        s, t = state.optimizer.state[p], got.optimizer.state[q]
        assert float(s["step"]) == float(t["step"]) == 2.0
        assert torch.equal(s["exp_avg"], t["exp_avg"]) and torch.equal(s["exp_avg_sq"], t["exp_avg_sq"])

    # the same next update from the original and the loaded state
    rng = np.random.RandomState(3)
    grads = [torch.as_tensor(rng.randn(*p.shape).astype(np.float32)) for p in state.model.parameters()]
    for s in (state, got):
        train_loop.apply_gradients(s, grads, torch.tensor(True), tcfg)
    for (n, a), (_, b) in zip(state.model.named_parameters(), got.model.named_parameters()):
        assert torch.equal(a, b), n


def test_train_state_bundle_absent_or_corrupt(tmp_path, capsys):
    tcfg = config.TrainConfig()
    state = _trained_state(tcfg, steps=1)
    template = train_loop.init_train_state(TensorProductScoreModel(tiny_configs(0)[1], device="cpu", seed=4), tcfg)
    before = {n: p.detach().clone() for n, p in template.model.named_parameters()}
    assert checkpoints.load_train_state(str(tmp_path), template) == (None, 0)
    checkpoints.save_train_state(str(tmp_path), state, epoch=1)
    path = tmp_path / f"{checkpoints.STATE_NAME}.msgpack"
    path.write_bytes(path.read_bytes()[:-100])
    assert checkpoints.load_train_state(str(tmp_path), template) == (None, 0)
    assert jckpt.load_train_state(str(tmp_path), _jax_template(state, jconfig.TrainConfig())) == (None, 0)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == f"corrupt train-state bundle {path} (ValueError); ignoring"
    assert all(torch.equal(p, before[n]) for n, p in template.model.named_parameters()) and template.step == 0
