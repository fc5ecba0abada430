"""The port's torsional pretraining (``train --dataset torsional``) against the
JAX package's, on the CPU.

Seeded small molecules written as SDFs (4-19 heavy atoms, each with a
rotatable bond; two ligand buckets), read by both packages:

* ``TorsionalDataset``: the same complexes, and ``epoch_batches`` the same
  batches in the same order for the same ``RandomState``, exactly;
* ``torsional_apply_draws`` with the JAX package's times and angle updates:
  positions within 1e-5 A, targets within 1e-5; ``torsional_loss`` within
  1e-6;
* ``torsional_forward`` against ``model.apply(..., method=
  model.torsional_forward)`` within 2e-4 x max(1, max |jax|), at a bucket
  (L % 8 == 0: pb at inference) and at a ligand's own atom count (L % 8 !=
  0: the composed pairs);
* the torsional train step at dropout 0 against ``jax.value_and_grad``:
  loss within 1e-4, every gradient rtol 2e-3 / atol 2e-4, the batch
  statistics 1e-4; the update (Adam with clipping, lr_scale, the EMA at
  ``ema_rate`` from the first step, the NaN skip) given the same gradients
  against optax and the JAX step's arithmetic at rtol 1e-6; the whole step
  and the eval step on the JAX package's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig, TrainConfig as JaxTrainConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg, torsional as jtors
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.train import diffusion as jdiff
from confidence_bootstrapping_tpu.train.train_loop import make_optimizer as jax_optimizer
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg, torsional
from confidence_bootstrapping_tpu_torch.data.conformers import mol_from_smiles
from confidence_bootstrapping_tpu_torch.data.mol_io import write_sdf
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.train import train_loop
from test_torch_common import install_jax_tables, port_batch, randomize_stats

# rotatable bonds in each; the last two over 16 heavy atoms (the L=24 bucket); one with a single heavy-atom
# bond only (no torsion: left out), one of 3 heavy atoms (left out)
SMILES = ("CCCCO", "CC(C)Cc1ccccc1", "OCCN(C)CC", "CCOC(=O)CCN", "c1ccccc1CCc1ccccc1", "CC(=O)Nc1ccc(O)cc1",
          "CCN(CC)CCOC(=O)c1ccc(N)cc1", "CC(C)Cc1ccc(cc1)C(C)C(=O)NCCO", "c1ccccc1", "CCO")
JCFG = dict(ns=8, nv=2, num_conv_layers=1, num_prot_emb_layers=2, lm_embedding_dim=0, dropout=0.0)
REL = 2e-4


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def sdf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mols")
    for i, smi in enumerate(SMILES):
        mol = mol_from_smiles(smi, seed=i)
        write_sdf(mol, mol.pos, str(d / f"m{i:02d}.sdf"), name=f"m{i:02d}")
    return str(d)


def _same_batch(port: tcg.ComplexBatch, jb) -> None:
    for f in tcg.ComplexBatch.__dataclass_fields__:
        a, b = getattr(port, f), getattr(jb, f, None)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_dataset_and_batches_equal_jax(sdf_dir):
    jds = jtors.TorsionalDataset(sdf_dir)
    ds = torsional.TorsionalDataset(sdf_dir, device="cpu")
    assert len(ds) == len(jds) == len(SMILES) - 2
    for a, b in zip(ds.complexes, jds.complexes):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or np.array_equal(np.asarray(x), np.asarray(y)), (a.name, f)
    assert {b.lig_pos.shape[1] for b in ds.epoch_batches(2, np.random.RandomState(0))} == {16, 24}
    for split in (None, np.asarray([1, 3, 5, 7])):
        p = torsional.TorsionalDataset(sdf_dir, split_idx=split, limit=6, device="cpu")
        j = jtors.TorsionalDataset(sdf_dir, split_idx=split, limit=6)
        assert [c.name for c in p.complexes] == [c.name for c in j.complexes]
    rp, rj = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):  # two epochs from one state: the same draws
        got, want = ds.epoch_batches(3, rp), jds.epoch_batches(3, rj)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_batch(a, b)
    assert rp.randint(1 << 30) == rj.randint(1 << 30)


def _jax_draws(jb, key, cfg):
    """The times and angle updates ``torsional_apply_noise`` draws from ``key``."""
    k_t, k_tor = jax.random.split(key)
    t = jdiff.sample_train_times(k_t, jb.batch_size, cfg)
    from confidence_bootstrapping_tpu.ops.schedules import t_to_sigma

    tor_sigma = t_to_sigma(t, t, t, JaxScoreConfig().sigma)[2]
    upd = jax.random.normal(k_tor, (jb.batch_size, jb.tor_src.shape[1])) * tor_sigma[:, None]
    return torsional.TorsionalDraws(torch.as_tensor(np.array(t)),
                                    torch.as_tensor(np.array(jnp.where(jb.tor_mask, upd, 0.0))))


@pytest.fixture(scope="module")
def case(sdf_dir):
    """A B=2 batch at the L=16 bucket and one at a ligand's own atom count (not a multiple of 8), the
    JAX package's noise on the first, the tiny model's variables, and the
    JAX loss, gradients and batch statistics of one training forward."""
    jds = jtors.TorsionalDataset(sdf_dir)
    jb = next(b for b in jds.epoch_batches(2, np.random.RandomState(0)) if b.lig_pos.shape[1] == 16)
    hc = next(c for c in jds.complexes if len(c.lig_f) % 8)
    b = jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), 1)._replace(L=len(hc.lig_f), N=1, KR=1)
    jodd = jcg.replicate_complex(jcg.pad_complex(hc, b, lm_dim=0), 2)
    tc = JaxTrainConfig()
    key = jax.random.PRNGKey(5)
    noised, targets = jtors.torsional_apply_noise(jb, key, JaxScoreConfig().sigma, tc)
    jmodel = JaxModel(JaxScoreConfig(**JCFG))
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))

    def loss_fn(params):
        pred, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, noised,
                                 deterministic=False, use_running_average=False, mutable=["batch_stats"],
                                 method=jmodel.torsional_forward)
        loss, base = jtors.torsional_loss(pred, targets, noised)
        return loss, (base, mut["batch_stats"])

    (loss, (base, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    forward = jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.torsional_forward))
    return dict(jb=jb, jodd=jodd, key=key, noised=noised, targets=targets, variables=variables,
                draws=_jax_draws(jb, key, tc), loss=float(loss), base=float(base),
                grads=from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)}),
                stats=from_flax.state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, stats)}),
                pred={"bucket": np.asarray(forward(variables, noised)), "own": np.asarray(forward(variables, jodd))})


def _model(variables):
    model = TensorProductScoreModel(ScoreModelConfig(**JCFG), device="cpu")
    return from_flax.load_flax_variables(model, variables)


def test_noise_and_loss_match_jax(case, monkeypatch):
    install_jax_tables(monkeypatch)
    pb = port_batch(case["jb"])
    noised, targets = torsional.torsional_apply_draws(pb, case["draws"], ScoreModelConfig().sigma)
    np.testing.assert_allclose(noised.lig_pos.numpy(), np.asarray(case["noised"].lig_pos), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(noised.t_tor.numpy(), np.asarray(case["noised"].t_tor))
    for got, want in zip(targets, case["targets"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float(targets.tor_score.abs().max()) > 0
    pred = np.random.RandomState(0).randn(*targets.tor_score.shape).astype(np.float32)
    jt = type(case["targets"])(*(jnp.asarray(t.numpy()) for t in targets))
    for p in (pred, np.zeros_like(pred)):
        got = torsional.torsional_loss(torch.as_tensor(p), targets, noised)
        want = jtors.torsional_loss(jnp.asarray(p), jt, case["noised"])
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6, atol=1e-6)
    # torsion only: bond lengths kept
    src, dst = pb.lig_edge_src[..., None].expand(-1, -1, 3), pb.lig_edge_dst[..., None].expand(-1, -1, 3)
    lengths = [torch.linalg.norm(torch.gather(p, 1, src) - torch.gather(p, 1, dst), dim=-1)[pb.lig_edge_mask]
               for p in (pb.lig_pos, noised.lig_pos)]
    np.testing.assert_allclose(lengths[1].numpy(), lengths[0].numpy(), atol=1e-4)


@pytest.mark.parametrize("which", ["bucket", "own"])
def test_torsional_forward_matches_jax(case, which, monkeypatch):
    """L=16 (pb at inference) and L % 8 != 0 (the pairs composed: conv_nbr and messages)."""
    install_jax_tables(monkeypatch)
    model = _model(case["variables"])
    batch = port_batch(case["noised"] if which == "bucket" else case["jodd"])
    assert (batch.lig_pos.shape[1] % 8 == 0) == (which == "bucket")
    got = model.torsional_forward(batch)
    want = case["pred"][which]
    assert np.abs(want).max() > 0 and got.shape == want.shape
    _close(got.numpy(), want)


def test_torsional_training_loss_and_gradients_match_jax(case, monkeypatch):
    install_jax_tables(monkeypatch)
    model = _model(case["variables"]).requires_grad_(True)
    noised = port_batch(case["noised"])
    targets = torsional.torsional_apply_draws(port_batch(case["jb"]), case["draws"], ScoreModelConfig().sigma)[1]
    pred = model.torsional_forward(noised, deterministic=False, use_running_average=False)
    loss, base = torsional.torsional_loss(pred, targets, noised)
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-4)
    np.testing.assert_allclose(base.item(), case["base"], rtol=1e-5)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    assert {n for n, _ in named} == set(case["grads"])
    moved = 0
    for (n, p), g in zip(named, grads):
        want = case["grads"][n].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4, err_msg=n)
        moved += bool(np.any(want != 0))
    # the receptor and the score heads take no part: their gradients are zero in both
    assert 0 < moved < len(named)
    for n, v in case["stats"].items():
        np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("grad_clip,lr_scale", [(None, 1.0), (0.5, 0.7)])
def test_torsional_update_matches_optax_and_the_jax_step(grad_clip, lr_scale, case, monkeypatch):
    """The whole port step on the JAX package's draws (dropout 0), then its
    update given the JAX gradients against optax and the JAX torsional
    step's EMA (ema_rate from the first step), two steps, the second with a
    non-finite loss (gradients zeroed, Adam and the EMA still run)."""
    install_jax_tables(monkeypatch)
    cfg, jcfg = TrainConfig(grad_clip=grad_clip), JaxTrainConfig(grad_clip=grad_clip)
    state = train_loop.init_train_state(_model(case["variables"]), cfg)
    state.lr_scale = lr_scale
    params0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    draws = case["draws"]
    monkeypatch.setattr(train_loop, "torsional_apply_noise",
                        lambda b, sigma, c, g: torsional.torsional_apply_draws(b, draws, sigma))
    m = train_loop.make_torsional_train_step(ScoreModelConfig(**JCFG), cfg)(
        state, port_batch(case["jb"]), torch.Generator().manual_seed(0))
    assert sorted(m) == ["loss", "skipped", "tor_base_loss"] and float(m["skipped"]) == 0.0 and state.step == 1
    np.testing.assert_allclose(float(m["loss"]), case["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(m["tor_base_loss"]), case["base"], rtol=1e-5)
    for n, v in case["stats"].items():  # the step keeps the statistics it produced
        np.testing.assert_allclose(state.model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)

    state = train_loop.init_train_state(_model(case["variables"]), cfg)
    state.lr_scale = lr_scale
    names = list(params0)
    tx = jax_optimizer(jcfg)

    @jax.jit
    def jax_update(params, opt, ema, ok):  # the JAX torsional step's update on the JAX gradients
        g = {n: jnp.where(ok, jnp.asarray(case["grads"][n].numpy()), 0.0) for n in names}
        updates, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: u * lr_scale, updates))
        return params, opt, jax.tree.map(lambda e, p: jcfg.ema_rate * e + (1 - jcfg.ema_rate) * p, ema, params)

    params = {n: jnp.asarray(params0[n].numpy()) for n in names}
    opt, ema = tx.init(params), params
    for ok in (True, False):
        params, opt, ema = jax_update(params, opt, ema, ok)
        grads = [case["grads"][n] * (1.0 if ok else float("nan")) for n in names]
        train_loop.apply_gradients(state, grads, torch.tensor(ok), cfg, ema_warmup=False)
        for n, p in state.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-6, atol=1e-7, err_msg=n)
            np.testing.assert_allclose(state.ema[n].numpy(), np.asarray(ema[n]), rtol=1e-6, atol=1e-7, err_msg=n)
    assert state.step == 2


def test_torsional_eval_step_matches_jax(case, monkeypatch):
    """The eval step on the JAX package's draws: the loss of JAX's inference
    forward; the batch statistics untouched."""
    install_jax_tables(monkeypatch)
    cfg = TrainConfig()
    state = train_loop.init_train_state(_model(case["variables"]), cfg)
    before = train_loop.batch_stats(state.model)
    draws = case["draws"]
    monkeypatch.setattr(train_loop, "torsional_apply_noise",
                        lambda b, sigma, c, g: torsional.torsional_apply_draws(b, draws, sigma))
    out = train_loop.make_torsional_eval_step(ScoreModelConfig(**JCFG), cfg)(
        state, port_batch(case["jb"]), torch.Generator().manual_seed(0))
    want = jtors.torsional_loss(jnp.asarray(case["pred"]["bucket"]), case["targets"], case["noised"])
    np.testing.assert_allclose([float(out["loss"]), float(out["tor_base_loss"])], [float(w) for w in want],
                               rtol=1e-4, atol=1e-6)
    assert all(torch.equal(b, before[n]) for n, b in state.model.named_buffers())
