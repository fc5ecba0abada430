"""The port's training step against the JAX package's, on the CPU.

* ``BatchNormIrreps`` in training: masked batch statistics (biased variance)
  and the running update with momentum 0.1, against the Flax module.
* The model: the tiny score model's training loss (``deterministic=False``,
  batch statistics, dropout 0) and the gradient of every parameter, against
  ``jax.value_and_grad`` of ``model.apply`` on the JAX XLA path, same
  weights (``models/from_flax``), same noised batch and targets; and the
  batch statistics the forward leaves. Tolerance: loss 1e-4 relative,
  gradients rtol 2e-3 / atol 2e-4 (the bar of tests/test_tpconv_train.py for
  whole-model gradients), statistics 1e-4. The gradients are compared before
  Adam: at step 1 Adam turns any tiny difference into a +-lr update.
* The update: Adam / AdamW with clipping, lr_scale, the EMA and the NaN skip
  (zeroed gradients, Adam and EMA still run) given identical gradients,
  against optax and ``make_train_step``'s arithmetic; the NaN step keeps the
  batch statistics; the eval step leaves them as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from confidence_bootstrapping_tpu.config import TrainConfig as JaxTrainConfig
from confidence_bootstrapping_tpu.models.layers import BatchNormIrreps as JaxBN
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.train import diffusion as jdiff
from confidence_bootstrapping_tpu.train.losses import score_matching_loss as jloss
from confidence_bootstrapping_tpu_torch.config import TrainConfig
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.layers import BatchNormIrreps
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.train import diffusion, losses, train_loop
from test_torch_common import both_batches, install_jax_tables, padded_1a0q, perturbed_pose, port_batch, randomize_stats, tiny_configs

IRREPS = "8x0e + 3x1o + 3x1e + 2x0o"


def test_batch_norm_training_statistics_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 7, 28) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(2, 7) > 0.3
    jbn = JaxBN(IRREPS)
    variables = randomize_stats(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)))
    out, mut = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), use_running_average=False,
                         mutable=["batch_stats"])
    bn = BatchNormIrreps(IRREPS)
    bn.load_state_dict({k: torch.as_tensor(np.array(v)) for c in ("params", "batch_stats") for k, v in variables[c].items()})
    got = bn(torch.as_tensor(x), torch.as_tensor(mask), use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    for k, v in mut["batch_stats"].items():
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    before = {k: b.clone() for k, b in bn.named_buffers()}
    bn(torch.as_tensor(x), torch.as_tensor(mask))  # running statistics: no update
    assert all(torch.equal(before[k], b) for k, b in bn.named_buffers())


@pytest.fixture(scope="module")
def model_case():
    """The JAX loss, gradients and new batch statistics of one training
    forward of the tiny model (computed once), with the port's inputs."""
    jcfg, tcfg = tiny_configs(0)
    padded = padded_1a0q(0)
    jb, _ = both_batches(padded, 2, lig_pos=perturbed_pose(padded, 2))
    noised, targets = jdiff.apply_noise(jb, jax.random.PRNGKey(3), jcfg.sigma, JaxTrainConfig())
    jmodel = JaxModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    tc = JaxTrainConfig()

    @jax.jit
    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, noised,
                                deterministic=False, use_running_average=False, mutable=["batch_stats"])
        lb = jloss(out.tr_pred, out.rot_pred, out.tor_pred, targets, noised, jcfg.sigma, tc.tr_weight, tc.rot_weight,
                   tc.tor_weight)
        return lb.loss, mut["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return dict(tcfg=tcfg, variables=variables, noised=port_batch(noised),
                targets=diffusion.ScoreTargets(*(torch.as_tensor(np.array(t)) for t in targets)),
                loss=float(loss), grads=from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)}),
                stats=from_flax.state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, new_stats)}))


def test_training_loss_and_every_gradient_match_jax(model_case, monkeypatch):
    install_jax_tables(monkeypatch)
    c = model_case
    model = TensorProductScoreModel(c["tcfg"], device="cpu")
    from_flax.load_flax_variables(model, c["variables"])
    model.requires_grad_(True)
    out = model(c["noised"], deterministic=False, use_running_average=False)
    tc = TrainConfig()
    lb = losses.score_matching_loss(out.tr_pred, out.rot_pred, out.tor_pred, c["targets"], c["noised"],
                                    c["tcfg"].sigma, tc.tr_weight, tc.rot_weight, tc.tor_weight)
    np.testing.assert_allclose(lb.loss.item(), c["loss"], rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(lb.loss, [p for _, p in model.named_parameters()], allow_unused=True)
    assert set(names) == set(c["grads"])
    nonzero = 0
    for n, g in zip(names, grads):
        want = c["grads"][n].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4, err_msg=n)
        nonzero += bool(np.any(want != 0))
    assert nonzero > 0.8 * len(names)
    for n, v in c["stats"].items():
        np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)


class _Tiny(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)
        self.lin.weight.data, self.lin.bias.data = torch.as_tensor(w).clone(), torch.as_tensor(b).clone()


@pytest.mark.parametrize("w_decay,grad_clip,lr_scale", [(0.0, None, 1.0), (0.01, 0.5, 0.7)])
def test_update_matches_optax_and_the_jax_step(w_decay, grad_clip, lr_scale):
    """Three updates given the same gradients, the second from a non-finite
    loss: parameters and EMA after each against optax and the JAX step's
    NaN skip and EMA arithmetic."""
    rng = np.random.RandomState(0)
    w, b = rng.randn(2, 3).astype(np.float32), rng.randn(2).astype(np.float32)
    cfg = TrainConfig(w_decay=w_decay, grad_clip=grad_clip)
    jcfg = JaxTrainConfig(w_decay=w_decay, grad_clip=grad_clip)
    from confidence_bootstrapping_tpu.train.train_loop import make_optimizer as jax_optimizer

    tx = jax_optimizer(jcfg)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    opt, ema = tx.init(params), params
    state = train_loop.init_train_state(_Tiny(w, b), cfg)
    state.lr_scale = lr_scale
    for step, ok in enumerate((True, False, True)):
        gw, gb = rng.randn(2, 3).astype(np.float32), rng.randn(2).astype(np.float32)
        if not ok:
            gw[0, 0] = np.nan
        g = jax.tree.map(lambda x: jnp.where(ok, x, 0.0), {"w": jnp.asarray(gw), "b": jnp.asarray(gb)})
        updates, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: u * lr_scale, updates))
        decay = min(jcfg.ema_rate, (1 + step) / (10 + step))
        ema = jax.tree.map(lambda e, p: decay * e + (1 - decay) * p, ema, params)
        train_loop.apply_gradients(state, [torch.as_tensor(gw), torch.as_tensor(gb)], torch.tensor(ok), cfg)
        lin = state.model.lin
        np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(params["w"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(params["b"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.ema["lin.weight"].numpy(), np.asarray(ema["w"]), rtol=1e-6, atol=1e-7)
    assert state.step == 3


def test_nan_step_keeps_batch_stats_and_eval_leaves_them(monkeypatch):
    """A step whose loss is not finite still moves the parameters (Adam on
    zeroed gradients with the moments of the step before) and the EMA, and
    keeps the batch statistics it started with; the eval step in
    batch-statistics mode leaves them too. Dropout 0.1, so the dropout masks
    run."""
    install_jax_tables(monkeypatch)
    _, tcfg = tiny_configs(0)
    tcfg = dataclasses.replace(tcfg, dropout=0.1)
    padded = padded_1a0q(0)
    _, tb = both_batches(padded, 2)
    state = train_loop.init_train_state(TensorProductScoreModel(tcfg, device="cpu"), TrainConfig())
    step = train_loop.make_train_step(tcfg, TrainConfig())
    gen = torch.Generator().manual_seed(0)
    m = step(state, tb, gen)
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["loss"]))
    stats = train_loop.batch_stats(state.model)
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    ema = {n: e.clone() for n, e in state.ema.items()}
    real_loss = train_loop.score_matching_loss
    monkeypatch.setattr(train_loop, "score_matching_loss",
                        lambda *a, **k: real_loss(*a, **k)._replace(loss=real_loss(*a, **k).loss * float("nan")))
    m = step(state, tb, gen)
    assert float(m["skipped"]) == 1.0 and state.step == 2
    assert all(torch.equal(b, stats[n]) for n, b in state.model.named_buffers())
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert any(not torch.equal(p, params[n]) for n, p in state.model.named_parameters())
    assert any(not torch.equal(e, ema[n]) for n, e in state.ema.items())
    monkeypatch.setattr(train_loop, "score_matching_loss", real_loss)
    evaluate = train_loop.make_eval_step(tcfg, TrainConfig(), use_running_average=False)
    out = evaluate(state, tb, torch.Generator().manual_seed(1))
    assert np.isfinite(float(out["loss"]))
    assert all(torch.equal(b, stats[n]) for n, b in state.model.named_buffers())
