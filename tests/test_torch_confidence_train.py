"""The port's confidence training against the JAX package, on the CPU.

* The confidence losses: the pose loss's three modes (binary cross-entropy
  on logits, one-hot binned cross-entropy, RMSD mean squared error) and the
  per-atom loss's two (binary, binned; padded atoms masked out of the mean),
  within 1e-6.
* ``MaskedBatchNorm1d`` in training (masked statistics over every leading
  axis, biased variance, the running update at momentum 0.1) against the
  Flax module: outputs and running statistics within 1e-5.
* Both models in training at dropout 0 (``deterministic=False``, batch
  statistics) against ``jax.value_and_grad`` of ``model.apply`` on the JAX
  XLA path, same weights (``models/from_flax``) and batch: the all-atom
  model at lmax=2 with the per-atom head on the cropped and compacted small
  1a0q complex of tests/test_torch_confidence.py, and the residue-level
  model in confidence mode (times as sigmas, the crop mask at a fixed
  cutoff) on a synthetic target of tests/test_bootstrapping.py. Loss within
  1e-4 relative, every gradient rtol 2e-3 / atol 2e-4, batch statistics
  1e-4 (the bar of tests/test_torch_training.py); the inference forwards
  within 2e-4 x max(1, max |jax|).
* One ``make_confidence_train_step`` update (crop, forward, loss, Adam with
  clipping, the EMA, the batch statistics) given the JAX gradients, against
  optax and the JAX step's arithmetic; the eval step leaves the batch
  statistics as they were.
* ``FilteringDataset``: the same seed gives the same picks, poses, times and
  labels as the JAX package's, in every label mode; a cache written by either
  package is read by the other; ``generate_filtering_cache`` on injected
  sampler output (final poses and trajectories) equals the JAX package's.
* ``roc_auc`` equal to the JAX one; ``trajectory_sweep`` on an injected
  trajectory and confidence function equal to the JAX one; a two-epoch
  ``train_confidence`` with the JAX package's history keys, and the state
  of the best validation accuracy.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig, TrainConfig as JaxTrainConfig
from confidence_bootstrapping_tpu.confidence import dataset as jdataset, train as jtrain
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models import all_atom_model as jaam
from confidence_bootstrapping_tpu.models.factory import confidence_model_config as jax_confidence_config
from confidence_bootstrapping_tpu.models.score_model import MaskedBatchNorm1d as JaxMBN
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu.train import losses as jlosses
from confidence_bootstrapping_tpu.train.train_loop import make_optimizer as jax_optimizer
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig, confidence_model_config
from confidence_bootstrapping_tpu_torch.confidence import dataset, train as ctrain
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.models import all_atom_model as taam, factory, from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import MaskedBatchNorm1d
from confidence_bootstrapping_tpu_torch.train import losses, train_loop
from test_bootstrapping import _synthetic_target
from test_torch_common import install_jax_tables, port_batch, randomize_stats
from test_torch_confidence import LM, small_complex

REL = 2e-4


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got), want, rtol=0,
                               atol=rel * scale)


def _port_target(jt):
    """The port's CBTarget of a JAX one (the molecule is not read here)."""
    from confidence_bootstrapping_tpu_torch.bootstrapping.finetune import CBTarget

    return CBTarget(tcg.HostComplex(**jt.hc._asdict()), None, lm_dim=jt.lm_dim, bucket=jt.bucket)


@functools.lru_cache(maxsize=None)
def _targets():
    """Two synthetic targets (tests/test_bootstrapping.py's), JAX and port."""
    jts = [_synthetic_target("AAAA_1", 0), _synthetic_target("BBBB_1", 1)]
    return jts, [_port_target(t) for t in jts]


# ----------------------------------------------------------------------------- losses and the head's batch norm


def _loss_inputs(mode, rng):
    b, L, nb = 5, 7, 3
    if mode == "bce":
        return rng.randn(b) * 3, (rng.rand(b) > 0.5).astype(np.float32), False
    if mode == "binned":
        return rng.randn(b, nb), np.eye(nb, dtype=np.float32)[rng.randint(nb, size=b)], False
    if mode == "rmsd":
        return rng.randn(b), rng.rand(b) * 6, True
    mask = rng.rand(b, L) > 0.3
    if mode == "atom_bce":
        return rng.randn(b, L, 1) * 3, (rng.rand(b, L) > 0.5).astype(np.float32), mask
    return rng.randn(b, L, nb), np.eye(nb, dtype=np.float32)[rng.randint(nb, size=(b, L))], mask


@pytest.mark.parametrize("mode", ["bce", "binned", "rmsd", "atom_bce", "atom_binned"])
def test_confidence_losses_match_jax(mode):
    pred, labels, extra = _loss_inputs(mode, np.random.RandomState(len(mode)))
    pred, labels = pred.astype(np.float32), labels.astype(np.float32)
    if mode.startswith("atom"):
        want = jlosses.atom_confidence_loss(jnp.asarray(pred), jnp.asarray(labels), jnp.asarray(extra))
        got = losses.atom_confidence_loss(torch.as_tensor(pred), torch.as_tensor(labels), torch.as_tensor(extra))
    else:
        want = jlosses.confidence_loss(jnp.asarray(pred), jnp.asarray(labels), extra)
        got = losses.confidence_loss(torch.as_tensor(pred), torch.as_tensor(labels), extra)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batch_norm_training_matches_flax(masked):
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 5, 6) * 2 + 0.7).astype(np.float32)
    mask = rng.rand(3, 5) > 0.4 if masked else None
    jbn = JaxMBN()
    jmask = None if mask is None else jnp.asarray(mask)
    variables = randomize_stats({"params": {"MaskedBatchNorm1d_0": {"scale": np.ones(6), "bias": np.zeros(6)}},
                                 "batch_stats": {"MaskedBatchNorm1d_0": {"mean": np.zeros(6), "var": np.ones(6)}}})
    variables = {c: v["MaskedBatchNorm1d_0"] for c, v in variables.items()}
    out, mut = jbn.apply(variables, jnp.asarray(x), jmask, False, mutable=["batch_stats"])
    bn = MaskedBatchNorm1d(6)
    bn.load_state_dict({k: torch.as_tensor(np.array(v, np.float32)) for c in variables.values() for k, v in c.items()})
    got = bn(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask), use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    for k, v in mut["batch_stats"].items():
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(v), rtol=1e-5, atol=1e-5, err_msg=k)
    before = {k: b.clone() for k, b in bn.named_buffers()}
    np.testing.assert_allclose(bn(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jbn.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                                                    jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(before[k], b) for k, b in bn.named_buffers())  # running statistics: no update


# ----------------------------------------------------------------------------- both models in training


AA_CFG = dict(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=LM, crop_beyond=7.0, crop_res_cap=16,
              crop_atom_cap=120, atom_confidence=True, dropout=0.0)
RES_CFG = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=16, dropout=0.0,
               confidence_mode=True, crop_beyond=6.0)
ATOM_W = 0.5  # the pretrained recipe's per-atom loss weight


def _variables(model, seed):
    """Flax variables of the port's seeded model (so no JAX init is
    compiled), with random batch-norm statistics."""
    return randomize_stats(from_flax.flax_from_state_dict(model), seed=seed)


def _jax_case(jmodel, variables, jb, labels, atom_w, inference: bool):
    """The JAX loss, gradients and new batch statistics of one training
    forward, as make_confidence_train_step's loss_fn takes them; with
    ``inference`` also the inference forward."""

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb, deterministic=False,
                                use_running_average=False, mutable=["batch_stats"])
        loss = jlosses.confidence_loss(out.confidence, labels["y"])
        if atom_w:
            loss = loss + atom_w * jlosses.atom_confidence_loss(out.atom_confidence, labels["atom_y"], jb.lig_mask)
        return loss, mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return dict(loss=float(loss), grads=from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)}),
                stats=from_flax.state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, stats)}),
                inference=jax.jit(jmodel.apply)(variables, jb) if inference else None)


@pytest.fixture(scope="module")
def all_atom_case():
    """The all-atom model at lmax=2 with the per-atom head: the JAX training
    forward on the cropped, compacted batch (computed once), with the port's
    model, full batch and labels."""
    padded, hc = small_complex()
    rng = np.random.RandomState(4)
    pos = padded["lig_pos"][None] + rng.randn(2, *padded["lig_pos"].shape).astype(np.float32) * np.array(
        [0.5, 3.0], np.float32)[:, None, None]
    jb = jcg.replicate_complex(padded, 2).replace(lig_pos=jnp.asarray(pos)).set_time(0.0, 0.0, 0.0)
    jmodel = jaam.AllAtomScoreModel(jax_confidence_config(**AA_CFG))
    jc, _, _ = jaam.compact_crop(jb, None, AA_CFG["crop_beyond"], AA_CFG["crop_res_cap"], AA_CFG["crop_atom_cap"])
    model = taam.AllAtomScoreModel(confidence_model_config(**AA_CFG), device="cpu", seed=5)
    variables = _variables(model, 2)
    from_flax.load_flax_variables(model, variables)
    L = len(hc.lig_f)
    d = np.zeros(pos.shape[:2], np.float32)
    d[:, :L] = np.linalg.norm(pos[:, :L] - hc.orig_lig_pos[None], axis=-1)
    labels = dict(y=np.array([1.0, 0.0], np.float32), atom_y=(d < 2.0).astype(np.float32))
    case = _jax_case(jmodel, variables, jc, labels, ATOM_W, False)
    case.update(variables=variables, model=model, batch=port_batch(jb), labels=labels)
    return case


@pytest.fixture(scope="module")
def residue_case():
    """The residue-level model in confidence mode on a synthetic target: the
    JAX training forward (computed once) with the port's model and batch."""
    jt = _targets()[0][0]
    rng = np.random.RandomState(6)
    pos = jt.padded["lig_pos"][None] + rng.randn(2, *jt.padded["lig_pos"].shape).astype(np.float32)
    jb = jcg.replicate_complex(jt.padded, 2).replace(lig_pos=jnp.asarray(pos)).set_time(0.0, 0.3, 0.3)
    jb = jb.replace(t_tr=jnp.asarray([0.0, 0.4], jnp.float32))
    jmodel = JaxModel(JaxScoreConfig(**RES_CFG))
    model = factory.get_model(ScoreModelConfig(**RES_CFG), device="cpu", seed=1)
    variables = _variables(model, 3)
    from_flax.load_flax_variables(model, variables)
    labels = dict(y=np.array([0.0, 1.0], np.float32))
    case = _jax_case(jmodel, variables, jb, labels, 0.0, True)
    case.update(variables=variables, model=model, batch=port_batch(jb), labels=labels)
    return case


def _check_training(c, batch, atom_w):
    model = c["model"]
    model.requires_grad_(True)
    saved = train_loop.batch_stats(model)
    out = model(batch, deterministic=False, use_running_average=False)
    loss = losses.confidence_loss(out.confidence, torch.as_tensor(c["labels"]["y"]))
    if atom_w:
        loss = loss + atom_w * losses.atom_confidence_loss(out.atom_confidence, torch.as_tensor(c["labels"]["atom_y"]),
                                                           batch.lig_mask)
    np.testing.assert_allclose(loss.item(), c["loss"], rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
    assert set(names) == set(c["grads"])
    nonzero = 0
    for n, g in zip(names, grads):
        want = c["grads"][n].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4, err_msg=n)
        nonzero += bool(np.any(want != 0))
    assert nonzero > 0.7 * len(names)
    assert set(c["stats"]) == {n for n, _ in model.named_buffers()}
    for n, v in c["stats"].items():
        np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)
    train_loop.keep_batch_stats(model, saved, torch.tensor(False))  # put the statistics back for the next test
    model.requires_grad_(False)


def test_all_atom_model_training_matches_jax(all_atom_case):
    """lmax=2, the per-atom head (its batch statistics over the real ligand
    atoms), the crop compaction before the forward. (Its inference forward
    against the JAX package's: tests/test_torch_confidence.py.)"""
    c = all_atom_case
    cfg = c["model"].cfg
    batch = taam.compact_crop(c["batch"], None, cfg.crop_beyond, cfg.crop_res_cap, cfg.crop_atom_cap)[0]
    _check_training(c, batch, ATOM_W)


def test_residue_level_confidence_mode_training_matches_jax(residue_case):
    """The times taken as sigmas, the crop mask at a fixed cutoff (some
    residues leave the cross lists), the heads; then the inference forward."""
    c = residue_case
    b = c["batch"]
    d = torch.cdist(b.lig_pos, b.rec_pos).masked_fill(~b.lig_mask[:, :, None], 1e9).amin(1)
    assert bool(((d >= RES_CFG["crop_beyond"]) & b.rec_mask).any()) and bool(((d < 6.0) & b.rec_mask).any())
    _check_training(c, b, 0.0)
    out = c["model"](b)
    assert out.atom_confidence is None
    _close(out.confidence, c["inference"].confidence)


def test_residue_level_score_mode_crop_matches_jax(monkeypatch):
    """The crop mask the factory no longer refuses, in score mode: cut at
    3 sigma_tr + crop_beyond (some residues leave the cross lists); the
    inference forward against the JAX model's."""
    install_jax_tables(monkeypatch)
    cfg = dict(RES_CFG, confidence_mode=False, crop_beyond=2.0)
    jt = _targets()[0][0]
    pos = jt.padded["lig_pos"][None] + np.random.RandomState(9).randn(2, *jt.padded["lig_pos"].shape).astype(
        np.float32)
    jb = jcg.replicate_complex(jt.padded, 2).replace(lig_pos=jnp.asarray(pos)).set_time(0.2, 0.2, 0.2)
    model = factory.get_model(ScoreModelConfig(**cfg), device="cpu", seed=2)
    variables = _variables(model, 4)
    from_flax.load_flax_variables(model, variables)
    tb = port_batch(jb)
    d = torch.cdist(tb.lig_pos, tb.rec_pos).masked_fill(~tb.lig_mask[:, :, None], 1e9).amin(1)
    tr_sigma = model.cfg.sigma.tr_sigma_min ** 0.8 * model.cfg.sigma.tr_sigma_max ** 0.2
    assert bool(((d >= 3 * tr_sigma + 2.0) & tb.rec_mask).any()) and bool(((d < 3 * tr_sigma + 2.0) & tb.rec_mask).any())
    want = jax.jit(JaxModel(JaxScoreConfig(**cfg)).apply)(variables, jb)
    got = model(tb)
    for name in ("tr_pred", "rot_pred", "tor_pred"):
        _close(getattr(got, name), getattr(want, name))


def test_confidence_train_step_update_matches_optax(all_atom_case, monkeypatch):
    """One step given the JAX gradients (the step's own backward replaced):
    the loss of the cropped forward, the parameters after Adam with clipping
    and lr_scale, the EMA and the batch statistics against optax and the
    JAX step's arithmetic; then the eval step leaves the statistics as they
    were and returns the inference forward's confidences."""
    c = all_atom_case
    model = c["model"]
    cfg, jcfg = TrainConfig(grad_clip=1.0, lr=3e-4), JaxTrainConfig(grad_clip=1.0, lr=3e-4)
    state = train_loop.init_train_state(model, cfg)
    state.lr_scale = 0.5
    names = [n for n, _ in model.named_parameters()]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = train_loop.batch_stats(model)
    monkeypatch.setattr(ctrain.torch.autograd, "grad", lambda loss, params, **kw: [c["grads"][n] for n in names])
    step = ctrain.make_confidence_train_step(model, cfg, atom_confidence_loss_weight=ATOM_W)
    metrics = step(state, c["batch"], c["labels"], torch.Generator().manual_seed(0))
    monkeypatch.undo()
    np.testing.assert_allclose(float(metrics["loss"]), c["loss"], rtol=1e-4)
    assert set(metrics) == {"loss", "confidence_loss", "atom_confidence_loss", "affinity_loss", "accuracy"}

    tx = jax_optimizer(jcfg)
    decay = min(jcfg.ema_rate, 1 / 10)

    @jax.jit
    def jax_update(params, grads):  # the JAX step's arithmetic after value_and_grad, lr_scale 0.5
        updates, _ = tx.update(grads, tx.init(params), params)
        new = optax.apply_updates(params, jax.tree.map(lambda u: u * 0.5, updates))
        return new, jax.tree.map(lambda e, p: decay * e + (1 - decay) * p, params, new)

    new, ema = jax_update(c["variables"]["params"], from_flax.flax_tree(model, dict(c["grads"])))
    want_p = from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, new)})
    want_e = from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, ema)})
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(state.ema[n].numpy(), want_e[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)
    for n, v in c["stats"].items():
        np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)
    assert state.step == 1

    stats1 = train_loop.batch_stats(model)
    loss, conf, _ = ctrain.make_confidence_eval_step(model, atom_confidence_loss_weight=ATOM_W)(state, c["batch"],
                                                                                                c["labels"])
    assert np.isfinite(float(loss)) and conf.shape == (2,)
    assert all(torch.equal(b, stats1[n]) for n, b in model.named_buffers())
    with torch.no_grad():  # the model back to the fixture's weights and statistics
        for n, p in model.named_parameters():
            p.copy_(params0[n])
        train_loop.keep_batch_stats(model, stats0, torch.tensor(False))
    model.requires_grad_(False)


# ----------------------------------------------------------------------------- the filtering datasets and caches


def _synthetic_cache(seed=0, frames=None):
    """{name: (positions, rmsds)} over the two synthetic targets: 6 poses
    each (or [frames, 6, L, 3] trajectories), RMSDs spread over 0-6 A."""
    rng = np.random.RandomState(seed)
    out = {}
    for t in _targets()[0]:
        L = len(t.hc.lig_f)
        shape = (6, L, 3) if frames is None else (frames, 6, L, 3)
        out[t.name] = ((t.hc.orig_lig_pos + rng.randn(*shape) * 1.5).astype(np.float32),
                       (rng.rand(6) * 6).astype(np.float32))
    return out


DATASET_MODES = {
    "balanced": dict(),
    "no_band": dict(rmsd_classification_upper=None, balance=False),
    "binned": dict(rmsd_classification_cutoff=[2.0, 4.0], balance=False),
    "rmsd": dict(rmsd_prediction=True, balance=False),
    "atom": dict(atom_label_cutoff=2.0),
    "atom_binned": dict(atom_label_cutoff=[1.0, 2.5], balance=False),
    "trajectory": dict(trajectory_sampling=True),
    "parallel": dict(parallel=2, balance=False),
}


@pytest.mark.parametrize("mode", sorted(DATASET_MODES))
def test_filtering_dataset_picks_and_labels_match_jax(mode):
    kw = DATASET_MODES[mode]
    jts, tts = _targets()
    cache = _synthetic_cache(frames=5 if mode == "trajectory" else None)
    jds = jdataset.FilteringDataset(jts, cache, seed=7, **kw)
    tds = dataset.FilteringDataset(tts, cache, seed=7, device="cpu", **kw)
    assert len(tds) == len(jds) and tds.statistics() == jds.statistics()
    for _ in range(3):
        jb, jl = jds.sample_batch(cache, 4)
        tb, tl = tds.sample_batch(cache, 4)
        assert tl.keys() == jl.keys()
        for k in jl:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
        for f in ("lig_pos", "t_tr", "t_rot", "t_tor", "rec_pos", "lig_mask"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    assert tds.rng.randint(1 << 30) == jds.rng.randint(1 << 30)


def test_filtering_dataset_refuses_affinities():
    """Refused until the affinity heads were ported; now the affinity labels
    ("affinity", and "affinity_valid" below the cutoff) in both layouts
    (one pose a row; groups of 2 poses of one complex) equal the JAX
    package's, as do the affinity terms and losses of both head layouts: the
    combined head's last column (only valid poses count) and the legacy
    model's one affinity per group (every group counts; its [B / P, P]
    filtering logits as one per pose, the JAX loss at batch size P)."""
    jts, tts = _targets()
    cache = _synthetic_cache()
    affs = {"AAAA_1": 5.0, "BBBB_1": -1.5}
    for parallel in (1, 2):
        jds = jdataset.FilteringDataset(jts, cache, seed=3, affinities=affs, parallel=parallel, balance=False)
        tds = dataset.FilteringDataset(tts, cache, seed=3, affinities=affs, parallel=parallel, balance=False,
                                       device="cpu")
        jl, tl = jds.sample_batch(cache, 4)[1], tds.sample_batch(cache, 4)[1]
        assert tl.keys() == jl.keys() >= {"affinity", "affinity_valid"}
        for k in jl:
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    rng = np.random.RandomState(1)
    y = (rng.rand(2) > 0.5).astype(np.float32)
    labels = dict(y=y, affinity=rng.randn(2).astype(np.float32), affinity_valid=np.array([1.0, 0.0], np.float32))
    tlabels = {k: torch.as_tensor(v) for k, v in labels.items()}
    conf, aff = rng.randn(2, 2).astype(np.float32), rng.randn(1).astype(np.float32)
    Out = lambda confidence, affinity=None: type("Out", (), dict(confidence=confidence, affinity=affinity))
    for parallel, c, a in ((1, conf, None), (2, conf[:1], aff)):
        jpred, jloss = jtrain._affinity_terms(Out(jnp.asarray(c), None if a is None else jnp.asarray(a)), labels,
                                              parallel)
        pred, loss = ctrain._affinity_terms(Out(torch.as_tensor(c), None if a is None else torch.as_tensor(a)),
                                            tlabels, parallel)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred).reshape(-1), rtol=1e-6)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(losses.confidence_loss(pred, tlabels["y"]).item(),
                                   float(jlosses.confidence_loss(jpred, jnp.asarray(y))), rtol=1e-6)
    for valid in (None, labels["affinity_valid"], np.zeros(2, np.float32)):
        got = losses.affinity_loss(torch.as_tensor(conf[:, 0]), tlabels["affinity"],
                                   None if valid is None else torch.as_tensor(valid))
        want = jlosses.affinity_loss(jnp.asarray(conf[:, 0]), jnp.asarray(labels["affinity"]),
                                     None if valid is None else jnp.asarray(valid))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_parallel_logits_above_batch_size_parallel_deviate_from_jax():
    """A recorded deviation: with ``parallel`` P the JAX step compares the
    legacy model's [B / P, P] filtering logits with the [B] labels as they
    are, which broadcasts only at B = P and raises above it; the port takes
    them as one logit per pose in batch order, so at B = 4, P = 2 it
    computes what the JAX loss gives on the flattened logits."""
    rng = np.random.RandomState(4)
    labels = dict(y=(rng.rand(4) > 0.5).astype(np.float32), affinity=rng.randn(4).astype(np.float32))
    conf, aff = rng.randn(2, 2).astype(np.float32), rng.randn(2).astype(np.float32)
    Out = lambda confidence, affinity: type("Out", (), dict(confidence=confidence, affinity=affinity))
    jpred, _ = jtrain._affinity_terms(Out(jnp.asarray(conf), jnp.asarray(aff)), labels, 2)
    with pytest.raises((TypeError, ValueError)):
        jlosses.confidence_loss(jpred, jnp.asarray(labels["y"]))
    pred, _ = ctrain._affinity_terms(Out(torch.as_tensor(conf), torch.as_tensor(aff)),
                                     {k: torch.as_tensor(v) for k, v in labels.items()}, 2)
    np.testing.assert_allclose(losses.confidence_loss(pred, torch.as_tensor(labels["y"])).item(),
                               float(jlosses.confidence_loss(jnp.asarray(conf).reshape(-1),
                                                             jnp.asarray(labels["y"]))), rtol=1e-6)


def _inject_sampler(monkeypatch, frames):
    """Both packages' randomize_position and sample replaced by the same
    seeded output: start poses frames[0], trajectory frames[1:] (positions
    [steps + 1, s, L_pad, 3])."""
    jnp_frames = jnp.asarray(frames)

    def jrand(batch, key, tr_sigma_max, *a, **k):
        return batch.replace(lig_pos=jnp_frames[0])

    def jsample(model, variables, batch, key, model_cfg, sampler_cfg, trajectory=False, *a, **k):
        return batch.replace(lig_pos=jnp_frames[-1]), jnp_frames[1:]

    def trand(batch, generator, tr_sigma_max, *a, **k):
        return batch.replace(lig_pos=torch.as_tensor(frames[0]))

    def tsample(model, batch, model_cfg, cfg, generator=None, return_trajectory=False, device=None):
        return batch.replace(lig_pos=torch.as_tensor(frames[-1])), (torch.as_tensor(frames[1:]) if return_trajectory
                                                                     else None)

    monkeypatch.setattr(jsampling, "randomize_position", jrand)
    monkeypatch.setattr(jsampling, "sample_jit", jsample)
    monkeypatch.setattr(jsampling, "sample", lambda m, v, b, k, mc, sc, return_trajectory=False: jsample(m, v, b, k,
                                                                                                         mc, sc))
    monkeypatch.setattr(dataset.sampling, "randomize_position", trand)
    monkeypatch.setattr(dataset.sampling, "sample", tsample)


@pytest.mark.parametrize("trajectory", [False, True])
def test_generate_filtering_cache_on_injected_samples_and_caches_cross_read(trajectory, monkeypatch, tmp_path):
    """The same injected rollouts give the same cache in both packages, and
    the pickle either one writes the other reads back bit for bit."""
    jts, tts = _targets()
    s, steps = 3, 2
    Lp = jts[0].padded["lig_pos"].shape[0]
    frames = (np.random.RandomState(5).randn(steps + 1, s, Lp, 3) * 2).astype(np.float32)
    _inject_sampler(monkeypatch, frames)
    cfg = JaxScoreConfig(**RES_CFG)
    want = jdataset.generate_filtering_cache(None, None, jts, jax.random.PRNGKey(0), cfg, s, steps,
                                             cache_path=str(tmp_path / "jax"), cache_id="x", trajectory=trajectory)
    got = dataset.generate_filtering_cache(None, tts, torch.Generator(), ScoreModelConfig(**RES_CFG), s, steps,
                                           cache_path=str(tmp_path / "port"), cache_id="x", trajectory=trajectory,
                                           device="cpu")
    name = dataset.filtering_cache_name("x", s, steps, trajectory)
    assert name == jdataset.filtering_cache_name("x", s, steps, trajectory)
    assert os.path.exists(tmp_path / "jax" / name) and os.path.exists(tmp_path / "port" / name)
    L = len(jts[0].hc.lig_f)
    for key in want:
        (jp, jr), (tp, tr) = want[key], got[key]
        assert tp.dtype == jp.dtype and tr.dtype == jr.dtype
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(tr, jr, rtol=1e-6)
        assert tp.shape == ((steps + 1, s, L, 3) if trajectory else (s, L, 3))
    monkeypatch.undo()
    for writer, reader in (("jax", "port"), ("port", "jax")):
        path = str(tmp_path / writer)
        if reader == "port":
            back = dataset.generate_filtering_cache(None, tts, None, None, s, steps, cache_path=path, cache_id="x",
                                                    trajectory=trajectory, device="cpu")
        else:
            back = jdataset.generate_filtering_cache(None, None, jts, None, None, s, steps, cache_path=path,
                                                     cache_id="x", trajectory=trajectory)
        src = want if writer == "jax" else got
        assert back.keys() == src.keys()
        for key in src:
            np.testing.assert_array_equal(back[key][0], src[key][0])
            np.testing.assert_array_equal(back[key][1], src[key][1])
    merged = dataset.combine_caches([got, want])
    jmerged = jdataset.combine_caches([got, want])
    for key in merged:
        np.testing.assert_array_equal(merged[key][0], jmerged[key][0])
        np.testing.assert_array_equal(merged[key][1], jmerged[key][1])


def test_binned_labels_and_perturbation_dataset_match_jax(monkeypatch):
    """binned_labels equal to the JAX one; PerturbationFilteringDataset
    picks the complexes the JAX one picks from the same RandomState, and
    labels each perturbed pose by its RMSD to the clean one."""
    install_jax_tables(monkeypatch)
    r = np.array([0.0, 1.99, 2.0, 3.5, 4.0, 9.0], np.float32)
    np.testing.assert_array_equal(dataset.binned_labels(r, [2.0, 4.0]), jdataset.binned_labels(r, [2.0, 4.0]))
    jts, tts = _targets()
    ds = dataset.PerturbationFilteringDataset(tts, ScoreModelConfig(**RES_CFG), rmsd_cutoff=3.0, device="cpu")
    assert ds.tcfg == TrainConfig(sampling_alpha=1.0, sampling_beta=1.0)
    batch, labels = ds.sample_batch(torch.Generator().manual_seed(0), 6, np.random.RandomState(2))
    idx = np.random.RandomState(2).randint(len(jts), size=6)  # the JAX dataset's picks
    clean = np.stack([jts[i].padded["lig_pos"] for i in idx])
    np.testing.assert_array_equal(batch.rec_pos.numpy(), np.stack([jts[i].padded["rec_pos"] for i in idx]))
    mask = np.stack([jts[i].padded["lig_mask"] for i in idx])
    d = batch.lig_pos.numpy() - clean
    rmsd = np.sqrt((d ** 2).sum(-1).sum(-1) / mask.sum(-1))
    np.testing.assert_array_equal(labels, (rmsd < 3.0).astype(np.float32))
    assert float(batch.t_tr.abs().max()) == 0.0 and rmsd.min() > 0


def test_roc_auc_matches_jax():
    rng = np.random.RandomState(0)
    labels = (rng.rand(40) > 0.4).astype(np.float32)
    scores = np.round(rng.randn(40) + labels, 1)  # ties
    assert ctrain.roc_auc(labels, scores) == jtrain.roc_auc(labels, scores)
    assert np.isnan(ctrain.roc_auc(np.ones(3), np.arange(3.0)))


def test_trajectory_sweep_on_an_injected_trajectory_matches_jax(monkeypatch):
    jts, tts = _targets()
    steps, s = 2, 3
    Lp = jts[0].padded["lig_pos"].shape[0]
    frames = (jts[0].padded["lig_pos"][None, None] + np.random.RandomState(8).randn(steps + 1, s, Lp, 3) * 2
              ).astype(np.float32)
    _inject_sampler(monkeypatch, frames)

    def conf(pos, crystal):  # a confidence function of the poses: positive near the crystal pose
        L = len(crystal)
        return 2.0 - np.sqrt(((np.asarray(pos)[:, :L] - crystal[None]) ** 2).sum(-1).mean(-1))

    crystal = jts[0].hc.orig_lig_pos
    monkeypatch.setattr(jsampling, "score_confidence", lambda m, v, b, lig_pos=None: jnp.asarray(conf(lig_pos, crystal)))
    monkeypatch.setattr(ctrain.sampling, "score_confidence",
                        lambda m, b, lig_pos=None: torch.as_tensor(conf(lig_pos, crystal)))
    cfg = JaxScoreConfig(**RES_CFG)
    want = jtrain.trajectory_sweep(None, None, None, None, jts[:1], cfg, jax.random.PRNGKey(0), steps, s)
    got = ctrain.trajectory_sweep(None, None, tts[:1], ScoreModelConfig(**RES_CFG), torch.Generator(), steps, s,
                                  device="cpu")
    assert len(got) == steps + 1 and [g["step"] for g in got] == [w["step"] for w in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["accuracy"] == w["accuracy"]
        np.testing.assert_allclose([g["mean_rmsd"], g["mean_score"]], [w["mean_rmsd"], w["mean_score"]], rtol=1e-6)


def test_train_confidence_two_epochs(monkeypatch):
    """Two epochs of the residue-level confidence model on a cache of the
    synthetic targets, validation on trajectory frames: the JAX package's
    history keys (confidence/train.py:142-145, :293-304), finite losses, the
    state of the best validation accuracy (its parameters put back), and
    the eval step leaving the batch statistics as they were."""
    _, tts = _targets()
    cfg = TrainConfig(batch_size=2, lr=1e-3)
    model = factory.get_model(dataclasses.replace(ScoreModelConfig(**RES_CFG), dropout=0.1), device="cpu")
    ds = dataset.FilteringDataset(tts, _synthetic_cache(1), rmsd_classification_upper=None, seed=0, device="cpu")
    vcache = _synthetic_cache(2, frames=3)
    vds = dataset.FilteringDataset(tts, vcache, rmsd_classification_upper=None, trajectory_sampling=True, seed=1,
                                   device="cpu")
    snaps = []
    real = ctrain._snapshot
    monkeypatch.setattr(ctrain, "_snapshot", lambda st: snaps.append(real(st)) or snaps[-1])
    state, history = ctrain.train_confidence(model, ds, _synthetic_cache(1), cfg, 2, 4, torch.Generator().manual_seed(3),
                                             val_dataset=vds, val_cache=vcache, log=lambda s: None)
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert set(h) == {"epoch", "train", "val"}
        assert set(h["train"]) == {"loss", "confidence_loss", "atom_confidence_loss", "affinity_loss", "accuracy"}
        assert set(h["val"]) == {"loss", "accuracy", "roc_auc", "per_t_accuracy"} and len(h["val"]["per_t_accuracy"]) == 21
        assert np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
    accs = [h["val"]["accuracy"] for h in history]
    best = snaps[-1]
    assert len(snaps) == (2 if accs[1] > accs[0] else 1) and state.step == best["step"]
    assert all(torch.equal(v, best["model"][k]) for k, v in state.model.state_dict().items())
    stats = train_loop.batch_stats(state.model)
    batch, labels = vds.sample_batch(vcache, 2)
    ctrain.make_confidence_eval_step(state.model)(state, batch, labels)
    assert all(torch.equal(b, stats[n]) for n, b in state.model.named_buffers())
