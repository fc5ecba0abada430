"""The residue-level score model's remainder against the JAX package: the
configurations the port refused before it took l=2 node blocks and plain
layers.

Each case builds the port's model from a seed (``factory.get_model``), carries
its weights and random batch-norm statistics to the JAX model
(``from_flax.flax_from_state_dict``), and compares on the small all-atom 1a0q
complex (64 residues; the residue-level model reads no atoms), B=2 poses at
ns=8, nv=2, two trunk layers, dropout 0:

* the inference forward against ``model.apply``, within 2e-4 x max(1, max
  |jax|) per output;
* the training forward (batch statistics of the batch), its loss within
  1e-4 and every gradient within rtol 2e-3 of ``jax.value_and_grad``, and the
  running statistics it leaves;
* its model directory read by the other package bit for bit, both ways.

One jitted JAX function a case computes both (its compile is most of the
cost). The cases: ``sh_lmax: 2`` with the side-chain head (its loss is
``sidechain_losses`` against seeded targets; the rest the squared scores),
the second-order irreps ladder at lmax=1 (the general route's kernels' plain
versions), and the plain layers: the depthwise product with 3-layer edge MLPs
and an unfixed center convolution (``fixed_center_conv: false``, which only
the legacy models read), in one model; then forwards alone of
``tp_weights_layers: 1`` and of the lmax=2 model in confidence mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models import factory as jfactory
from confidence_bootstrapping_tpu.train import checkpoints as jcheckpoints, losses as jlosses
from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
from confidence_bootstrapping_tpu_torch.models import factory, from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.train import checkpoints, losses, train_loop
from test_torch_common import install_jax_score_norms, perturbed_pose, port_batch, randomize_stats
from test_torch_confidence import LM, small_complex

REL = 2e-4
BASE = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=0, lm_embedding_dim=LM, dropout=0.0)
CASES = {
    "lmax2_sidechain": dict(sh_lmax=2, sidechain_pred=True),
    "second_order": dict(use_second_order_repr=True),
    "plain_layers": dict(depthwise_convolution=True, tp_weights_layers=3, fixed_center_conv=False, no_torsion=True),
}
FORWARD_ONLY = {
    "tp_weights_layers_1": dict(tp_weights_layers=1, no_torsion=True),
    "lmax2_confidence": dict(sh_lmax=2, confidence_mode=True),
}


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def batches():
    padded, _ = small_complex()
    jb = jcg.replicate_complex(padded, 2).replace(lig_pos=jnp.asarray(perturbed_pose(padded, 2, seed=3)))
    jb = jb.set_time(0.6, 0.5, 0.4)
    rng = np.random.RandomState(12)
    side = rng.rand(2, jb.rec_pos.shape[1], 10).astype(np.float32)
    side[:, :5, 3] = np.nan  # a chi angle some residues do not have
    return jb, port_batch(jb), side


def _scores(out, mod, side, mask):
    """The training loss of a case: the squared scores, plus the side-chain
    losses where the head is on."""
    loss = sum(mod.sum(getattr(out, f) ** 2) for f in ("tr_pred", "rot_pred", "tor_pred"))
    if out.sidechain_pred is not None:
        sl = (losses if mod is torch else jlosses).sidechain_losses(out.sidechain_pred, side, mask)
        loss = loss + sl[0] + sl[1]
    return loss


def _case(kw, jb, side, train: bool, seed: int):
    """(port model, its batch-stat-randomized variables, the JAX results)."""
    cfg = dict(BASE, **kw)
    model = factory.get_model(ScoreModelConfig(**cfg), device="cpu", seed=seed)
    variables = randomize_stats(from_flax.flax_from_state_dict(model), seed=seed)
    from_flax.load_flax_variables(model, variables)
    jmodel = jfactory.get_model(JaxScoreConfig(**cfg))

    def run(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        out = jmodel.apply(v, jb)
        if not train:
            return out

        def loss_fn(p):
            o, mut = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb, deterministic=False,
                                  use_running_average=False, mutable=["batch_stats"])
            return _scores(o, jnp, jnp.asarray(side), jb.rec_mask), mut["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, loss, grads, stats

    res = jax.jit(run)(variables["params"])
    return model, res


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, batches):
    install = pytest.MonkeyPatch()
    install_jax_score_norms(install)
    jb, tb, side = batches
    model, res = _case(CASES[request.param], jb, side, True, seed=sorted(CASES).index(request.param))
    yield request.param, model, res, tb, side
    install.undo()


def test_forward_matches_jax(case):
    name, model, (want, _, _, _), tb, _ = case
    assert isinstance(model, TensorProductScoreModel)
    got = model(tb)
    for f in ("tr_pred", "rot_pred", "tor_pred", "sidechain_pred"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None or not getattr(got, f).any(), f
            continue
        _close(getattr(got, f), getattr(want, f), what=f"{name} {f}")
    assert float(np.abs(np.asarray(want.tr_pred)).max()) > 0


def test_training_loss_and_gradients_match_jax(case):
    name, model, (_, loss, grads, stats), tb, side = case
    grads = from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)})
    stats = from_flax.state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, stats)})
    model.requires_grad_(True)
    saved = train_loop.batch_stats(model)
    try:
        out = model(tb, deterministic=False, use_running_average=False)
        got = _scores(out, torch, torch.as_tensor(side), tb.rec_mask)
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
        named = list(model.named_parameters())
        assert {n for n, _ in named} == set(grads)
        g = torch.autograd.grad(got, [p for _, p in named], allow_unused=True)
        nonzero = 0
        for (n, p), gn in zip(named, g):
            want = grads[n].numpy()
            gn = np.zeros_like(want) if gn is None else gn.numpy()
            np.testing.assert_allclose(gn, want, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(want).max(initial=0))),
                                       err_msg=f"{name} {n}")
            nonzero += bool(np.any(want != 0))
        assert nonzero > 0.7 * len(named)
        for n, v in stats.items():
            np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)
    finally:
        train_loop.keep_batch_stats(model, saved, torch.tensor(False))
        model.requires_grad_(False)


def test_model_dirs_round_trip_both_ways(case, tmp_path, capsys):
    """The port's model directory read by the JAX package's
    ``load_model_dir`` (its template: the trees of JAX's own gradients and
    batch statistics) bit for bit, and the JAX package's directory (the
    weights shifted) read by the port's loader bit for bit: the depthwise
    linear maps, the third edge-MLP layers, the side-chain head and the
    second-order and lmax=2 layers by their Flax names."""
    name, model, (_, _, grads, stats), _, _ = case
    checkpoints.save_model_dir(str(tmp_path / "port"), model.cfg, model)
    template = {"params": jax.tree.map(np.asarray, grads), "batch_stats": jax.tree.map(np.asarray, stats)}
    jcfg, got = jcheckpoints.load_model_dir(str(tmp_path / "port"), template)
    assert jcfg == JaxScoreConfig(**dict(BASE, **CASES[name]))
    got = jax.tree.map(np.asarray, got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(from_flax.flax_from_state_dict(model))):
        np.testing.assert_array_equal(a, b)
    shifted = jax.tree.map(lambda a: a + 0.25, got)
    jcheckpoints.save_model_dir(str(tmp_path / "jax"), jcfg, shifted)
    back, cfg = load_or_init_model(str(tmp_path / "jax"), "last_model", device="cpu")
    assert "loaded weights" in capsys.readouterr().out and cfg == model.cfg
    for a, b in zip(jax.tree.leaves(from_flax.flax_from_state_dict(back)), jax.tree.leaves(shifted)):
        np.testing.assert_array_equal(a, b)


def test_routes_of_the_cases():
    """The second-order ladder's trunk takes the general kernels, also at
    lmax=1; the plain layers no kernel; lmax=2 the general ones."""
    for name, want in (("second_order", {"general"}), ("plain_layers", {None}), ("lmax2_sidechain", {"general"})):
        model = factory.get_model(ScoreModelConfig(**dict(BASE, **CASES[name])), device="cpu")
        assert {layer.route for layer in model.conv_layers} == want, name
    plain = factory.get_model(ScoreModelConfig(**dict(BASE, **CASES["plain_layers"])), device="cpu")
    assert all(layer.depthwise and len(layer.edge_mlps[0].layers) == 3 for layer in plain.conv_layers)


@pytest.mark.parametrize("name", sorted(FORWARD_ONLY))
def test_forward_alone_matches_jax(name, batches, monkeypatch):
    install_jax_score_norms(monkeypatch)
    jb, tb, side = batches
    model, want = _case(FORWARD_ONLY[name], jb, side, False, seed=7)
    got = model(tb)
    fields = ("confidence",) if model.cfg.confidence_mode else ("tr_pred", "rot_pred", "tor_pred")
    for f in fields:
        _close(getattr(got, f), getattr(want, f), what=f"{name} {f}")
