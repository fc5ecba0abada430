"""The sampler's remainder against the JAX package: ``SamplerConfig``'s
per-manifold schedule, initial-noise and SVGD fields, ``make_schedules`` with
``different_schedules``, ``get_torsion_angles``, ``_svgd_perturbations`` and a
reverse step with SVGD, ``randomize_position`` around a pocket center, and the
padded complex's dihedral tuples.

The tiny score model of tests/test_torch_sampling.py (weights carried over by
the bridge) on the padded 1a0q complex, B=3 poses. Draws are JAX's: the
noise a step or the prior draws from its key, rebuilt here and handed to the
port. Tolerances (ROADMAP.md, "Measured margins"): positions after a step
within 2.7e-5 A; SVGD's perturbations, sums over the B poses of model-sized
terms, within 2e-4 x max(1, max |jax|) as the models are; torsion angles
within 1e-5 rad; schedules and dihedral tuples exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu import config as jconfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.ops import torsion as jtorsion
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu_torch import config
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.ops import torsion
from confidence_bootstrapping_tpu_torch.sampler import sampling
from test_torch_common import PKL, assert_port_fields, both_batches, install_jax_score_norms, padded_1a0q, \
    perturbed_pose, tiny_configs

B = 3
STEP_ATOL = 2.7e-5  # A, a sampler step
REL = 2e-4  # x max(1, max |jax|), as the models
ANGLE_ATOL = 1e-5  # rad
SVGD = dict(svgd_weight_log_0=-1.0, svgd_weight_log_1=0.5, svgd_repulsive_weight_log_0=0.0,
            svgd_repulsive_weight_log_1=1.0, svgd_kernel_size_log_0=-0.5, svgd_kernel_size_log_1=0.5,
            svgd_langevin_weight_log_0=-1.0, svgd_langevin_weight_log_1=-0.3, svgd_rot_log_rel_weight=0.4,
            svgd_tor_log_rel_weight=-0.2)
NEW_FIELDS = ("different_schedules", "rot_sigma_schedule", "rot_inf_sched_alpha", "rot_inf_sched_beta",
              "tor_sigma_schedule", "tor_inf_sched_alpha", "tor_inf_sched_beta", "initial_noise_std_proportion",
              *SVGD, "svgd_use_x0")


@pytest.fixture(scope="module")
def setup():
    padded = padded_1a0q(0)
    jb, tb = both_batches(padded, B, lig_pos=perturbed_pose(padded, B, seed=4, scale=2.0))
    jcfg, tcfg = tiny_configs(0)
    jmodel = JaxModel(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    model = TensorProductScoreModel(tcfg, device="cpu")
    from_flax.load_flax_variables(model, variables)
    return dict(padded=padded, jb=jb, tb=tb, jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, model=model)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("kw", [{}, dict(different_schedules=True, rot_sigma_schedule="expbeta", rot_inf_sched_alpha=2.0,
                                         tor_inf_sched_beta=0.5, initial_noise_std_proportion=0.5, svgd_use_x0=True,
                                         **SVGD)])
def test_sampler_config_has_every_jax_field(kw):
    """Every field of the JAX SamplerConfig, in its order, with its defaults;
    the 19 this slice adds among them, and non-default values kept."""
    got, want = config.SamplerConfig(**kw), jconfig.SamplerConfig(**kw)
    d = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
    jd = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    jdefaults = {f.name: getattr(jconfig.SamplerConfig(), f.name) for f in dataclasses.fields(want)}
    assert_port_fields(d, jd, jdefaults, every=True)
    assert set(NEW_FIELDS) <= set(d) and len(NEW_FIELDS) == 19


@pytest.mark.parametrize("kw", [dict(different_schedules=True, rot_inf_sched_alpha=2.0, tor_inf_sched_beta=0.5),
                                dict(different_schedules=True, rot_sigma_schedule="expbeta", tor_inf_sched_alpha=0.7,
                                     actual_steps=12, t_max=0.6)])
def test_make_schedules_different_schedules(kw):
    want = jsampling.make_schedules(jconfig.SamplerConfig(**kw))
    got = sampling.make_schedules(config.SamplerConfig(**kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert not np.array_equal(got.t_tr, got.t_rot) and not np.array_equal(got.t_rot, got.t_tor)


def test_get_torsion_angles(setup):
    dih = setup["padded"]["tor_dihedral"]
    pos = perturbed_pose(setup["padded"], 4, seed=7, scale=1.0)
    want = np.asarray(jtorsion.get_torsion_angles(jnp.asarray(dih), jnp.asarray(pos)))
    got = torsion.get_torsion_angles(torch.as_tensor(dih), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ANGLE_ATOL)
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("use_x0", [False, True])
def test_svgd_perturbations(setup, use_x0):
    """``_svgd_perturbations`` on the same scores and noise, midway through
    a 20-step schedule."""
    s = setup
    rng = np.random.RandomState(3)
    R = s["jb"].tor_src.shape[1]
    scores = [rng.randn(*shape).astype(np.float32) for shape in ((B, 3), (B, 3), (B, R))]
    zs = [rng.randn(*shape).astype(np.float32) for shape in ((B, 3), (B, 3), (B, R))]
    gs, dts = (3.0, 1.2, 0.8), (0.05, 0.05, 0.05)
    kw = dict(SVGD, svgd_use_x0=use_x0)
    jcfg, cfg = jconfig.SamplerConfig(**kw), config.SamplerConfig(**kw)
    step = 9
    want = jsampling._svgd_perturbations(
        s["jb"], jcfg, jnp.float32(step / 20), *map(jnp.asarray, scores), *map(jnp.asarray, zs),
        *map(jnp.float32, gs), *map(jnp.float32, dts), jsampling.make_schedules(jcfg), step, s["jcfg"])
    t = lambda a: torch.as_tensor(a)
    got = sampling._svgd_perturbations(s["tb"], cfg, step / 20, tuple(map(t, scores)), tuple(map(t, zs)),
                                       tuple(torch.tensor(g) for g in gs), tuple(torch.tensor(d) for d in dts),
                                       sampling.make_schedules(cfg), step, s["tcfg"])
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_svgd_reverse_step(setup, monkeypatch):
    """A stochastic step with SVGD on, the noise JAX draws from the step's key."""
    install_jax_score_norms(monkeypatch)
    s = setup
    step_idx = 6
    jscfg, scfg = jconfig.SamplerConfig(**SVGD), config.SamplerConfig(**SVGD)
    key = jax.random.PRNGKey(5)
    jcache = jax.jit(functools.partial(s["jmodel"].apply, method="embed_receptor"))(s["variables"], s["jb"])
    jstep = jax.jit(lambda v, b, c, k: jsampling.reverse_diffusion_step(
        s["jmodel"], v, b, c, k, jnp.int32(step_idx), jsampling.make_schedules(jscfg), s["jcfg"], jscfg))
    want = jstep(s["variables"], s["jb"], jcache, key).lig_pos
    k_tr, k_rot, k_tor = jax.random.split(key, 3)
    R = s["jb"].tor_src.shape[1]
    tr_z, rot_z, tor_z = (torch.as_tensor(np.asarray(jax.random.normal(k, shape)))
                          for k, shape in ((k_tr, (B, 3)), (k_rot, (B, 3)), (k_tor, (B, R))))
    got = sampling.reverse_diffusion_step(s["model"], s["tb"], s["model"].embed_receptor(s["tb"]), step_idx,
                                          sampling.make_schedules(scfg), s["tcfg"], scfg, tr_z=tr_z, rot_z=rot_z,
                                          tor_z=tor_z).lig_pos
    plain = sampling.reverse_diffusion_step(s["model"], s["tb"], s["model"].embed_receptor(s["tb"]), step_idx,
                                            sampling.make_schedules(config.SamplerConfig()), s["tcfg"],
                                            config.SamplerConfig(), tr_z=tr_z, rot_z=rot_z, tor_z=tor_z).lig_pos
    assert float((got - plain).abs().max()) > 1e-2  # SVGD changed the step
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(no_random=True), dict(initial_noise_std_proportion=0.3)])
def test_randomize_position_pocket_center(setup, kw):
    """The prior around a given pocket center, the draws JAX makes from the key."""
    s = setup
    key = jax.random.PRNGKey(8)
    center = np.asarray([[1.0, -2.0, 3.0], [0.5, 0.5, 0.5], [-4.0, 0.0, 2.0]], np.float32)
    want = jsampling.randomize_position(s["jb"], key, 3.0, pocket_center=jnp.asarray(center), **kw).lig_pos
    k_tor, k_rot, k_tr = jax.random.split(key, 3)
    draws = dict(tor_u=jax.random.uniform(k_tor, s["jb"].tor_src.shape, minval=-np.pi, maxval=np.pi),
                 rot_q=jax.random.normal(k_rot, (B, 4)), tr_z=jax.random.normal(k_tr, (B, 3)))
    got = sampling.randomize_position(s["tb"], None, 3.0, pocket_center=torch.as_tensor(center), **kw,
                                      **{k: torch.as_tensor(np.asarray(v)) for k, v in draws.items()}).lig_pos
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL)
    if kw.get("no_random"):
        m = s["padded"]["lig_mask"]
        np.testing.assert_allclose(got.numpy()[:, m].mean(1), center, atol=1e-4)


def test_pad_complex_tor_dihedral():
    """The dihedral tuples of the padded complex, and of a batch of them."""
    hc = tcg.load_host_complex(PKL)
    bucket = tcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))
    with open(PKL, "rb") as f:
        import pickle

        jhc = pickle.load(f)[0]
    want = jcg.pad_complex(jhc, jcg.Bucket(*bucket), 0)["tor_dihedral"]
    got = tcg.pad_complex(hc, bucket, 0)["tor_dihedral"]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and (got[: len(hc.tor_src)] != 0).any() and not got[len(hc.tor_src):].any()
    b = tcg.replicate_complex(tcg.pad_complex(hc, bucket, 0), 2, device="cpu")
    assert b.tor_dihedral.shape == (2, bucket.R, 4)
