"""The port's legacy models (``models/legacy.py``) against the JAX package's.

Both legacy architectures at small widths (ns=8, nv=2, 3 trunk layers,
sh_lmax=2 as the published models, smooth edges, 16-wide ESM features): the
residue-level score model on the padded 1a0q complex, the all-atom model on
the small all-atom complex of tests/test_torch_confidence.py. Weights are the
port's seeded ones with random batch-norm statistics, carried to JAX by
``from_flax.flax_from_state_dict``. On the CPU every TP-conv of the port runs
its plain version (the edge-list kernel's route at inference included).
Tolerances: outputs within 2e-4 x max(1, max |jax|); in training at dropout 0
the loss within 1e-4 relative and every gradient within rtol 2e-3 / atol
2e-4 of ``jax.value_and_grad``; a 3-step ODE rollout within 1.1e-4 A.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from confidence_bootstrapping_tpu.config import SamplerConfig as JaxSamplerConfig
from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.models import legacy as jlegacy
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
from confidence_bootstrapping_tpu_torch.models import factory, from_flax, legacy
from confidence_bootstrapping_tpu_torch.sampler import sampling
from test_torch_common import both_batches, install_jax_score_norms, padded_1a0q, perturbed_pose, randomize_stats
from test_torch_confidence import small_complex

REL = 2e-4
POS_ATOL = 1.1e-4
LM = 16
RES = dict(ns=8, nv=2, sh_lmax=2, num_conv_layers=3, lm_embedding_dim=LM, dropout=0.0, old_score_model=True,
           smooth_edges=True)
AA = dict(RES, all_atoms=True)
AFFINITY = dict(AA, confidence_mode=True, affinity_prediction=True, parallel=2, no_aminoacid_identities=True,
                lm_embedding_dim=0, num_conv_layers=2)
CASES = {
    "score": dict(RES, num_conv_layers=2),
    "confidence": dict(RES, confidence_mode=True, separate_noise_schedule=True, use_old_atom_encoder=True),
    "aa_score": dict(AA, separate_noise_schedule=True, num_conv_layers=2),
    "aa_confidence": dict(AA, confidence_mode=True, use_old_atom_encoder=True, num_confidence_outputs=3),
    "affinity": AFFINITY,
}
AGGREGATORS = ("mean", "max", "min", "std")


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def _batches(cfg: dict, B: int = 2):
    """(JAX batch, port batch): 1a0q for the residue-level model, the small
    all-atom complex for the all-atom one; jittered poses, t=0.4 (t=0 for a
    confidence model, as ``score_confidence`` sets it)."""
    padded = small_complex()[0] if cfg.get("all_atoms") else padded_1a0q(LM)
    t = 0.0 if cfg.get("confidence_mode") else 0.4
    return both_batches(padded, B, lig_pos=perturbed_pose(padded, B, seed=3, scale=1.0), t=t)


@functools.lru_cache(maxsize=None)
def _models(key: str):
    """(JAX model, Flax variables, port model) of CASES[key]."""
    cfg = CASES[key]
    model = factory.get_model(ScoreModelConfig(**cfg), device="cpu", seed=7)
    variables = randomize_stats(from_flax.flax_from_state_dict(model), seed=2)
    from_flax.load_flax_variables(model, variables)
    jcfg = JaxScoreConfig(**cfg)
    return (jlegacy.OldAllAtomScoreModel if cfg.get("all_atoms") else jlegacy.OldTensorProductScoreModel)(jcfg), \
        variables, model


def batch_size(key: str) -> int:
    return 4 if key == "affinity" else 2


@functools.lru_cache(maxsize=None)
def jax_outputs(key: str) -> dict:
    """The JAX model's outputs on ``_batches`` (computed once, also read by
    tests/test_torch_convert.py)."""
    jmodel, variables, _ = _models(key)
    return {n: np.asarray(v) for n, v in _outputs(jax.jit(jmodel.apply)(variables, _batches(CASES[key],
                                                                                          batch_size(key))[0])).items()}


def _outputs(out):
    """The arrays of a model output by name (score or confidence mode)."""
    names = ("confidence", "affinity") if getattr(out, "confidence", None) is not None else (
        "tr_pred", "rot_pred", "tor_pred")
    return {n: getattr(out, n) for n in names if getattr(out, n, None) is not None}


def check_forward(key: str, model) -> None:
    """``model``'s outputs on ``_batches`` against the JAX model's."""
    want, got = jax_outputs(key), _outputs(model(_batches(CASES[key], batch_size(key))[1]))
    assert got.keys() == want.keys() and got
    for n in want:
        assert tuple(got[n].shape) == tuple(want[n].shape), n
        _close(got[n], want[n])


@pytest.mark.parametrize("key", sorted(CASES))
def test_legacy_forward_matches_jax(key, monkeypatch):
    """Both models in score and confidence mode; the affinity model's
    filtering logits [B / 2, 2] and one affinity per group of 2 poses."""
    install_jax_score_norms(monkeypatch)
    _, _, model = _models(key)
    assert isinstance(model, legacy.OldAllAtomScoreModel if "aa" in key or key == "affinity"
                      else legacy.OldTensorProductScoreModel)
    check_forward(key, model)


@pytest.mark.parametrize("name", AGGREGATORS)
def test_pose_aggregators_match_jax(name):
    """Each of the affinity head's pose aggregators (std with ddof 1)
    against the JAX package's, on [groups, parallel, ns] features."""
    x = np.random.RandomState(0).randn(3, 4, 8).astype(np.float32)
    np.testing.assert_allclose(legacy._AGGREGATORS[name](torch.as_tensor(x)).numpy(),
                               np.asarray(jlegacy._AGGREGATORS[name](jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def _loss(out):
    return sum((v ** 2).mean() for v in _outputs(out).values())


def test_affinity_model_training_matches_jax():
    """deterministic=False, use_running_average=False at dropout 0, B=8 (4
    groups for the affinity head's batch statistics): every group on the
    edge-list op, the smooth edge weights multiplying its messages; loss,
    every gradient and the new batch statistics. A
    gradient may miss the tolerance only in the first-layer rows of hidden
    units at the ReLU (``chip_smoke.relu_units``), at most 4 rows in all."""
    jmodel, variables, model = _models("affinity")
    jb, tb = _batches(AFFINITY, B=8)

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb, deterministic=False,
                                use_running_average=False, mutable=["batch_stats"])
        return _loss(out), mut["batch_stats"]

    (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want_grads = from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, want_grads)})
    want_stats = from_flax.state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, want_stats)})
    saved = {n: b.clone() for n, b in model.named_buffers()}
    model.requires_grad_(True)
    try:
        out, at_relu = chip_smoke.relu_units(model, lambda: model(tb, deterministic=False,
                                                                      use_running_average=False))
        loss = _loss(out)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
        assert set(names) == set(want_grads)
        nonzero = excused = 0
        for n, g in zip(names, grads):
            want = want_grads[n].numpy()
            got = np.zeros_like(want) if g is None else g.numpy()
            off = np.abs(got - want) > 2e-4 + 2e-3 * np.abs(want)
            rows = set(np.nonzero(off.reshape(len(want), -1).any(-1))[0].tolist())
            assert rows <= set(at_relu.get(n.rsplit(".", 1)[0], [])), (n, rows)  # only rows of units at the ReLU
            excused += len(rows)
            nonzero += bool(np.any(want != 0))
        assert nonzero > 0.7 * len(names) and excused <= 4
        for n, v in want_stats.items():
            np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)
    finally:
        model.requires_grad_(False)
        for n, b in model.named_buffers():
            b.copy_(saved[n])


def test_legacy_sample_and_score_confidence_match_jax(monkeypatch):
    """A 3-step ODE rollout through ``sample`` (no receptor cache), and the
    legacy confidence model through ``score_confidence``."""
    install_jax_score_norms(monkeypatch)
    jmodel, variables, model = _models("score")
    padded = padded_1a0q(LM)
    jb, tb = both_batches(padded, 2, lig_pos=perturbed_pose(padded, 2, seed=1, scale=2.0))
    kw = dict(inference_steps=3, ode=True)
    want, _ = jsampling.sample_jit(jmodel, variables, jb, jax.random.PRNGKey(0), jmodel.cfg, JaxSamplerConfig(**kw))
    got, _ = sampling.sample(model, tb, model.cfg, SamplerConfig(**kw), torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_allclose(got.lig_pos.numpy(), np.asarray(want.lig_pos), rtol=0, atol=POS_ATOL)

    # score_confidence with no receptor cache: the JAX model's forward at t=0 on the same poses
    cmodel = _models("confidence")[2]
    tb_c = _batches(CASES["confidence"])[1]
    _close(sampling.score_confidence(cmodel, tb_c.set_time(0.7, 0.7, 0.7)), jax_outputs("confidence")["confidence"])


def test_factory_dispatches_the_legacy_models():
    for key, cls in (("score", legacy.OldTensorProductScoreModel), ("aa_confidence", legacy.OldAllAtomScoreModel)):
        assert type(factory.get_model(ScoreModelConfig(**CASES[key]), device="cpu")) is cls
    # the second-order irreps ladder, refused before the port took l = 2 node blocks: built
    second = factory.get_model(ScoreModelConfig(**dict(RES, use_second_order_repr=True)), device="cpu")
    assert type(second) is legacy.OldTensorProductScoreModel and "2e" in second.irrep_seq[1]


def test_legacy_edge_routes():
    """Every trunk layer of the ns=24/nv=6 legacy all-atom model (H=72)
    takes a tensor-core build of the edge-list kernel, and every layer of
    DiffDock's ns=48/nv=10 legacy score model (H=144) a build, at any list
    length: a one-edge list puts the most receivers in a block, so the most
    shared memory. The route is fixed when the layer is built: only the
    lmax=2 torsion head, whose harmonics reach l=4, keeps the plain
    composition."""
    model = legacy.OldAllAtomScoreModel(ScoreModelConfig(**dict(AFFINITY, ns=24, nv=6, num_conv_layers=5)),
                                        device="cpu")
    for name, mod in model.named_modules():
        if hasattr(mod, "edge_build"):
            assert mod.edge_kernel, name
            for K in (1, 2, 16, 24, 32, 48, 64, 2048):
                assert mod.edge_build(K) == (True, 64), (name, K)
    score = legacy.OldTensorProductScoreModel(
        ScoreModelConfig(lm_embedding_dim=0, old_score_model=True, **chip_smoke.LEGACY_SCORE), device="cpu")
    plain = []
    for name, mod in score.named_modules():
        if hasattr(mod, "edge_build"):
            if not mod.edge_kernel:
                plain.append(name)
                continue
            assert mod.edge_build(1)[1] == mod.edge_build(24)[1] == mod.edge_build(2048)[1], name
    assert plain == ["tor_bond_conv"] and not score.tor_bond_conv.kernel_harmonics
