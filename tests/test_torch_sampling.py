"""The port's sampler against the JAX package's, and the port as a whole.

Same tiny score model as tests/test_torch_score_model.py (weights carried
over by the bridge) on the padded 1a0q complex, B=2 poses. The noise of a
stochastic step is the exact noise JAX's threefry draws, rebuilt here from the
step's key as sampling.py does it and handed to the port's step.
Tolerance: positions agree within 1e-3 A after a step or a 3-step rollout
(coordinates are tens of A; the model outputs agree to 2e-4 relative and
enter the update scaled by g^2 dt).
"""

import ast
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.config import SamplerConfig as JaxSamplerConfig
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu_torch.config import SamplerConfig
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.sampler import sampling
from test_torch_common import ROOT, both_batches, install_jax_score_norms, padded_1a0q, perturbed_pose, tiny_configs

B = 2
POS_ATOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    padded = padded_1a0q(0)
    jb, tb = both_batches(padded, B, lig_pos=perturbed_pose(padded, B, seed=1, scale=2.0))
    jcfg, tcfg = tiny_configs(0)
    jmodel = JaxModel(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    model = TensorProductScoreModel(tcfg, device="cpu")
    from_flax.load_flax_variables(model, variables)
    return dict(jb=jb, tb=tb, jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, model=model)


def _pos_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=POS_ATOL)


def test_make_schedules_matches_jax():
    for kw in (dict(inference_steps=20), dict(inference_steps=20, actual_steps=12),
               dict(inference_steps=7, inf_sched_alpha=2.0, inf_sched_beta=1.5, t_max=0.8)):
        want = jsampling.make_schedules(JaxSamplerConfig(**kw))
        got = sampling.make_schedules(SamplerConfig(**kw))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step_idx,ode", [(5, False), (19, False), (3, True)])
def test_reverse_step_matches_jax(setup, step_idx, ode, monkeypatch):
    install_jax_score_norms(monkeypatch)
    s = setup
    jscfg, scfg = JaxSamplerConfig(ode=ode, no_final_step_noise=True), SamplerConfig(ode=ode, no_final_step_noise=True)
    key = jax.random.PRNGKey(11)
    jcache = jax.jit(functools.partial(s["jmodel"].apply, method="embed_receptor"))(s["variables"], s["jb"])
    jstep = jax.jit(lambda v, b, c, k: jsampling.reverse_diffusion_step(
        s["jmodel"], v, b, c, k, step_idx, jsampling.make_schedules(jscfg), s["jcfg"], jscfg))
    want = jstep(s["variables"], s["jb"], jcache, key).lig_pos
    # the noise sampling.py:159-163 draws from this key
    k_tr, k_rot, k_tor = jax.random.split(key, 3)
    R = s["jb"].tor_src.shape[1]
    tr_z, rot_z, tor_z = (torch.as_tensor(np.asarray(jax.random.normal(k, shape)))
                          for k, shape in ((k_tr, (B, 3)), (k_rot, (B, 3)), (k_tor, (B, R))))
    cache = s["model"].embed_receptor(s["tb"])
    got = sampling.reverse_diffusion_step(s["model"], s["tb"], cache, step_idx, sampling.make_schedules(scfg),
                                          s["tcfg"], scfg, tr_z=tr_z, rot_z=rot_z, tor_z=tor_z).lig_pos
    assert float((got - s["tb"].lig_pos).abs().max()) > 1e-2  # the step moved the poses
    _pos_close(got, want)


@pytest.mark.parametrize("phases", [dict(), dict(rec_phase_steps=(1, 2), rec_phase_caps=(256, 128))])
def test_ode_rollout_matches_jax(setup, phases, monkeypatch):
    """3-step probability-flow rollout, shared receptor embedding, with and
    without two receptor compaction boundaries (N 512 -> 256 -> 128)."""
    install_jax_score_norms(monkeypatch)
    s = setup
    kw = dict(inference_steps=3, ode=True, **phases)
    want, _ = jsampling.sample_jit(s["jmodel"], s["variables"], s["jb"], jax.random.PRNGKey(0), s["jcfg"],
                                   JaxSamplerConfig(**kw))
    got, traj = sampling.sample(s["model"], s["tb"], s["tcfg"], SamplerConfig(**kw), torch.Generator().manual_seed(0),
                                return_trajectory=True, device="cpu")
    assert traj.shape == (3,) + tuple(s["tb"].lig_pos.shape)
    _pos_close(got.lig_pos, want.lig_pos)


def test_compact_receptor_matches_jax(setup):
    """One phase boundary: the same residues kept in the same order, the kNN
    lists remapped alike, the cached embeddings gathered alike."""
    s = setup
    jcache = jax.jit(functools.partial(s["jmodel"].apply, method="embed_receptor"))(s["variables"], s["jb"])
    jnb, jnc = jsampling._compact_receptor(s["jb"], jcache, 25.0, 128)
    nb, nc = sampling._compact_receptor(s["tb"], s["model"].embed_receptor(s["tb"]), 25.0, 128)
    assert 0 < int(nb.rec_mask[0].sum()) <= 128
    for f in ("rec_f", "rec_pos", "rec_mask", "rec_nbr", "rec_nbr_mask", "rec_lm"):
        np.testing.assert_array_equal(getattr(nb, f).numpy(), np.asarray(getattr(jnb, f)), err_msg=f)
    np.testing.assert_array_equal(nc.rec_edge_mask.numpy(), np.asarray(jnc.rec_edge_mask))
    np.testing.assert_allclose(nc.rec_attr.numpy(), np.asarray(jnc.rec_attr), rtol=0, atol=2e-4)
    np.testing.assert_allclose(nc.rec_edge_emb.numpy(), np.asarray(jnc.rec_edge_emb), rtol=0, atol=2e-4)


def test_phase_plan_validation():
    with pytest.raises(ValueError):
        sampling._phase_plan(SamplerConfig(rec_phase_steps=(0, 3), rec_phase_caps=(16,)), 20)
    with pytest.raises(ValueError):
        sampling._phase_plan(SamplerConfig(rec_phase_steps=(3, 0), rec_phase_caps=(16, 8)), 20)
    with pytest.raises(ValueError):
        sampling._phase_plan(SamplerConfig(rec_phase_steps=(0, 3), rec_phase_caps=(8, 16)), 20)
    assert sampling._phase_plan(SamplerConfig(rec_phase_steps=(6, 12), rec_phase_caps=(256, 128)), 20) == (
        (6, 256), (12, 128))
    assert sampling._phase_plan(SamplerConfig(), 20) == ()


def test_randomize_position(setup):
    """The t=1 prior: seeded; with no translation noise the centroid lands on
    the receptor center, and without torsions the pose moves rigidly."""
    tb = setup["tb"]
    g = lambda: torch.Generator().manual_seed(5)
    a = sampling.randomize_position(tb, g(), 19.0)
    b = sampling.randomize_position(tb, g(), 19.0)
    assert torch.equal(a.lig_pos, b.lig_pos)
    rigid = sampling.randomize_position(tb, g(), 19.0, no_torsion=True, no_random=True)
    m = tb.lig_mask[0]
    center = rigid.lig_pos[:, m].mean(1)
    rec_center = tb.rec_pos[0, tb.rec_mask[0]].mean(0)
    torch.testing.assert_close(center, rec_center.expand_as(center), rtol=0, atol=1e-3)
    d0 = torch.cdist(tb.lig_pos[:, m], tb.lig_pos[:, m])
    torch.testing.assert_close(torch.cdist(rigid.lig_pos[:, m], rigid.lig_pos[:, m]), d0, rtol=0, atol=1e-3)


def test_receptor_cache_shared_equals_per_pose(setup):
    s = setup
    shared = sampling.receptor_cache(s["model"], s["tb"], shared=True)
    full = sampling.receptor_cache(s["model"], s["tb"], shared=False)
    for a, b in zip(shared, full):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_entry_points_need_a_device_or_cpu():
    """With no card, the entry points raise unless the caller asks for the
    CPU; nothing falls back to it quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, tcfg = tiny_configs(0)
    hc = tcg.load_host_complex(os.path.join(ROOT, "cache", "1a0q_44f574e0e5cb3bc5.pkl"))
    padded = tcg.pad_complex(hc, tcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)),
                             lm_dim=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorProductScoreModel(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcg.replicate_complex(padded, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.sample(TensorProductScoreModel(tcfg, device="cpu"), tcg.replicate_complex(padded, 2, "cpu"), tcfg,
                        SamplerConfig(inference_steps=2))
    with pytest.raises(RuntimeError):
        TensorProductScoreModel(tcfg, device="cuda")


_PORT = os.path.join(ROOT, "confidence_bootstrapping_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "yaml", "msgpack", "confidence_bootstrapping_tpu")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_never_imports_jax():
    """No source of the port, nor chip_smoke.py, names JAX, flax, yaml or the
    JAX package in an import; and importing every module of the port (and
    loading the committed featurization cache) leaves them out of
    sys.modules."""
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(_PORT):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in sources:
        bad = set(_imported_roots(path)) & set(_FORBIDDEN)
        assert not bad, f"{path} imports {bad}"
    code = (
        "import importlib, pkgutil, sys\n"
        "import confidence_bootstrapping_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_complex\n"
        "hc = load_host_complex('cache/1a0q_44f574e0e5cb3bc5.pkl')\n"
        "assert (len(hc.lig_f), len(hc.rec_f)) == (23, 416), hc.name\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "print('ok')\n" % (_FORBIDDEN,)
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
