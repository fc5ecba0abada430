"""The all-atom model's score mode and the sampler's remainder against the JAX
package.

On the small all-atom 1a0q complex (64 residues, 512 seeded atoms), B=2 poses,
ns=8, nv=2, dropout 0, the port's seeded weights carried to JAX
(``from_flax.flax_from_state_dict``) with random batch-norm statistics:

* the all-atom model in score mode (lmax=2, one protein-embedding layer with
  the ligand's, two trunk layers, the score-mode crop 3 sigma_tr +
  ``crop_beyond`` cutting residues): its forward against ``model.apply``
  within 2e-4 x max(1, max |jax|), its training loss within 1e-4 and its
  gradients within rtol 2e-3 of ``jax.value_and_grad``; its model directory
  read by the other package bit for bit, both ways (the JAX side's template
  the tree JAX's own gradients come in);
* a 3-step sample of the slice's paths A (the all-atom score model, no phase
  plan), B (the residue-level model at lmax=2) and C (the second-order ladder
  at lmax=1), each step's noise the normals JAX's threefry draws from the
  step's key, fed to the port's step: final positions within 1.1e-4 A. The
  schedule runs from t=0.35 (sigma_tr 0.63 A) to 0, steps of about 1 A, from
  poses near the crystal's: from t=1 a step moves poses by up to 77 A, and
  the two packages' scores, within 1e-5 relative of each other there (the
  forward's bar is 2e-4), put positions up to 4e-4 A apart;
* ``score_confidence(embed_full_receptor=True)``: the full receptor
  embedded once and compacted with the batch into the crop caps, against
  the JAX package's, within 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.config import SamplerConfig as JaxSamplerConfig, ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models import factory as jfactory
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu.train import checkpoints as jcheckpoints
from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig, confidence_model_config
from confidence_bootstrapping_tpu_torch.models import factory, from_flax
from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel, crops
from confidence_bootstrapping_tpu_torch.sampler import sampling
from confidence_bootstrapping_tpu_torch.train import checkpoints, train_loop
from test_torch_common import install_jax_tables, perturbed_pose, port_batch, randomize_stats
from test_torch_confidence import LM, small_complex

REL = 2e-4
POS_ATOL = 1.1e-4
BASE = dict(ns=8, nv=2, lm_embedding_dim=LM, dropout=0.0)
AA_SCORE = dict(BASE, all_atoms=True, sh_lmax=2, num_conv_layers=2, num_prot_emb_layers=1, crop_beyond=2.0,
                no_torsion=True)
PATHS = {  # the slice's paths at test size (torsions off: the torsion heads are held in the forward tests)
    "A": dict(AA_SCORE, crop_beyond=10.0, num_prot_emb_layers=0),
    "B": dict(BASE, sh_lmax=2, num_conv_layers=2, num_prot_emb_layers=0, no_torsion=True),
    "C": dict(BASE, use_second_order_repr=True, num_conv_layers=2, num_prot_emb_layers=0, no_torsion=True),
}


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _models(cfg: dict, seed: int, jax_cfg=JaxScoreConfig):
    model = factory.get_model(ScoreModelConfig(**cfg), device="cpu", seed=seed)
    variables = randomize_stats(from_flax.flax_from_state_dict(model), seed=seed)
    from_flax.load_flax_variables(model, variables)
    return model, variables, jfactory.get_model(jax_cfg(**cfg))


@pytest.fixture(scope="module")
def complex_():
    padded, _ = small_complex()
    jb = jcg.replicate_complex(padded, 2).replace(lig_pos=jnp.asarray(perturbed_pose(padded, 2, seed=5, scale=2.0)))
    return padded, jb


@pytest.fixture(scope="module")
def aa_case(complex_):
    """The all-atom score model at t=0.2 (tr_sigma ~1.8 A: the crop at ~7.5 A
    cuts residues): the JAX inference forward, training loss, gradients and
    batch statistics, one jit."""
    install = pytest.MonkeyPatch()
    install_jax_tables(install)
    jb = complex_[1].set_time(0.2, 0.3, 0.4)
    model, variables, jmodel = _models(AA_SCORE, seed=3)

    def run(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb)

        def loss_fn(p):
            o, mut = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb, deterministic=False,
                                  use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(o.tr_pred ** 2) + jnp.sum(o.rot_pred ** 2), mut["batch_stats"]

        return out, jax.value_and_grad(loss_fn, has_aux=True)(params)

    out, ((loss, stats), grads) = jax.jit(run)(variables["params"])
    yield dict(model=model, variables=variables, tb=port_batch(jb), out=out, loss=float(loss),
               grads=jax.tree.map(np.asarray, grads), stats=jax.tree.map(np.asarray, stats))
    install.undo()


def test_all_atom_score_forward_matches_jax(aa_case):
    c = aa_case
    model, tb = c["model"], c["tb"]
    assert isinstance(model, AllAtomScoreModel) and not model.cfg.confidence_mode
    d = torch.cdist(tb.lig_pos, tb.rec_pos).masked_fill(~tb.lig_mask[:, :, None], 1e9).amin(1)
    cut = 3 * model.cfg.sigma.tr_sigma_min ** 0.8 * model.cfg.sigma.tr_sigma_max ** 0.2 + AA_SCORE["crop_beyond"]
    assert bool(((d >= cut) & tb.rec_mask).any()) and bool(((d < cut) & tb.rec_mask).any())  # the crop cuts
    got = model(tb)
    for f in ("tr_pred", "rot_pred", "tor_pred"):
        _close(getattr(got, f), getattr(c["out"], f), what=f)
    assert float(np.abs(np.asarray(c["out"].tr_pred)).max()) > 0


def test_all_atom_score_training_matches_jax(aa_case):
    c = aa_case
    model, tb = c["model"], c["tb"]
    grads = from_flax.state_dict_from_flax({"params": c["grads"]})
    stats = from_flax.state_dict_from_flax({"batch_stats": c["stats"]})
    model.requires_grad_(True)
    saved = train_loop.batch_stats(model)
    try:
        out = model(tb, deterministic=False, use_running_average=False)
        loss = torch.sum(out.tr_pred ** 2) + torch.sum(out.rot_pred ** 2)
        np.testing.assert_allclose(loss.item(), c["loss"], rtol=1e-4)
        named = list(model.named_parameters())
        assert {n for n, _ in named} == set(grads)
        for (n, _), g in zip(named, torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)):
            want = grads[n].numpy()
            got = np.zeros_like(want) if g is None else g.numpy()
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(want).max(initial=0))),
                                       err_msg=n)
        for n, v in stats.items():
            np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)
    finally:
        train_loop.keep_batch_stats(model, saved, torch.tensor(False))
        model.requires_grad_(False)


def test_all_atom_score_model_dirs_round_trip(aa_case, tmp_path, capsys):
    """The port's directory read by the JAX package's ``load_model_dir`` (its
    template: JAX's own gradient and statistics trees) bit for bit, and the
    JAX package's directory read by the port's loader, weights bit for bit."""
    c = aa_case
    model, cfg = c["model"], c["model"].cfg
    checkpoints.save_model_dir(str(tmp_path / "port"), cfg, model)
    template = {"params": c["grads"], "batch_stats": c["stats"]}
    jcfg, got = jcheckpoints.load_model_dir(str(tmp_path / "port"), template)
    assert jcfg == JaxScoreConfig(**AA_SCORE)
    ours = from_flax.flax_from_state_dict(model)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)), jax.tree.leaves(ours)):
        np.testing.assert_array_equal(a, b)
    shifted = jax.tree.map(lambda a: a + 0.5, jax.tree.map(np.asarray, got))
    jcheckpoints.save_model_dir(str(tmp_path / "jax"), jcfg, shifted)
    back, back_cfg = load_or_init_model(str(tmp_path / "jax"), "last_model", device="cpu")
    assert "loaded weights" in capsys.readouterr().out and back_cfg == cfg and isinstance(back, AllAtomScoreModel)
    for a, b in zip(jax.tree.leaves(from_flax.flax_from_state_dict(back)), jax.tree.leaves(shifted)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_step_sample_matches_jax(path, complex_, monkeypatch):
    install_jax_tables(monkeypatch)
    jb = complex_[1]
    model, variables, jmodel = _models(PATHS[path], seed=11)
    kw = dict(inference_steps=3, t_max=0.35)
    key = jax.random.PRNGKey(4)
    want, _ = jsampling.sample_jit(jmodel, variables, jb, key, jmodel.cfg, JaxSamplerConfig(**kw))
    scfg = SamplerConfig(**kw)
    sched, tb = sampling.make_schedules(scfg), port_batch(jb)
    cache = sampling.receptor_cache(model, tb, scfg.shared_receptor)
    assert sampling._phase_plan(scfg, 3) == () or not model.cfg.all_atoms
    for i, k in enumerate(jax.random.split(key, 3)):  # sampling.py's keys, then each step's three draws
        k_tr, k_rot, k_tor = jax.random.split(k, 3)
        z = [torch.as_tensor(np.asarray(jax.random.normal(kk, shape))) for kk, shape in
             ((k_tr, (2, 3)), (k_rot, (2, 3)), (k_tor, tuple(jb.tor_src.shape)))]
        tb = sampling.reverse_diffusion_step(model, tb, cache, i, sched, model.cfg, scfg, None, *z)
    assert float((tb.lig_pos - port_batch(jb).lig_pos).abs().max()) > 0.3  # the poses moved
    np.testing.assert_allclose(tb.lig_pos.numpy(), np.asarray(want.lig_pos), rtol=0, atol=POS_ATOL)


def test_score_confidence_embedding_the_full_receptor_matches_jax(complex_, monkeypatch):
    """The crop packs 16 of 64 residues: the cache of the full receptor,
    embedded once, is compacted with the batch for the trunk."""
    install_jax_tables(monkeypatch)
    jb = complex_[1]
    cfg = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, embed_also_ligand=True, lm_embedding_dim=LM,
               crop_beyond=7.0, crop_res_cap=16, crop_atom_cap=120, dropout=0.0)
    model = factory.get_model(confidence_model_config(**cfg), device="cpu", seed=2)
    variables = randomize_stats(from_flax.flax_from_state_dict(model), seed=2)
    from_flax.load_flax_variables(model, variables)
    jmodel = jfactory.get_model(jfactory.confidence_model_config(**cfg))
    tb = port_batch(jb)
    assert crops(model.cfg, tb)
    want = jax.jit(lambda v, b: jsampling.score_confidence(jmodel, v, b, embed_full_receptor=True))(variables, jb)
    got = sampling.score_confidence(model, tb, embed_full_receptor=True)
    _close(got, want)
