"""The port's Confidence Bootstrapping loop against the JAX package, on the CPU.

* ``CBBuffer`` and ``BootstrappingDataset``: the same calls give the same
  picks, statistics and batch buckets (both draw from
  ``np.random.RandomState(0)``); exact.
* ``inference_epoch`` on the small all-atom 1a0q complex of
  tests/test_torch_confidence.py with the sampler stubbed to the same poses
  in both packages: oracle, model (the CLI's confidence function: replicate
  the target, set the poses, ``score_confidence``, the ns=8 confidence model
  with the port's seeded weights in both) and no confidence give the same
  kept items and metrics. RMSDs within 1e-5 A, confidences within 2e-4 x
  max(1, max |jax|), counts exact; skip-and-continue up to
  ``limit_failures`` the same.
* The fine-tune's ``TrainConfig``, equal to the one the JAX loop builds.
* A two-epoch ``inference_finetune`` of the port on two synthetic targets
  (tests/test_bootstrapping.py's): its history, its workdir (msgpack files
  read by the JAX package's ``load_params``, equal to the port's weights),
  and every rollout on a second model holding the EMA parameters and the
  training model's buffers while the training model, its optimizer and its
  EMA stay as they were.
* ``generate_bootstrapping_complexes``: written to its cache, read back.
* The entry points raise without a card unless given ``device="cpu"``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu import config as jconfig
from confidence_bootstrapping_tpu.bootstrapping import buffer as jbuffer, finetune as jft, offline_dataset as joffline
from confidence_bootstrapping_tpu.data.mol_io import Molecule as JaxMolecule
from confidence_bootstrapping_tpu.models import all_atom_model as jaam
from confidence_bootstrapping_tpu.models.factory import confidence_model_config as jax_confidence_config
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu.train import checkpoints as jckpt
from confidence_bootstrapping_tpu_torch import config
from confidence_bootstrapping_tpu_torch.bootstrapping import buffer, finetune, offline_dataset
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.models import all_atom_model as taam, from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.sampler import sampling
from test_bootstrapping import _synthetic_target
from test_torch_common import PKL, assert_port_fields, install_jax_tables
from test_torch_confidence import LM, SMALL, small_complex

RMSD_ATOL = 1e-5
REL = 2e-4
N_POSES = 6


# ----------------------------------------------------------------------------- the buffer


def _item(name, conf, n_res=16, ident=0.0):
    """A padded stand-in whose lig_pos names it, in a bucket by n_res."""
    return ({"lig_pos": np.full((8, 3), ident, np.float32), "rec_pos": np.zeros((n_res, 3), np.float32)}, name, conf)


def _rounds(two_buckets):
    rng = np.random.RandomState(7)
    names = ["AAAA_1", "AAAA_2", "BBBB_1", "CCCC_1"]
    out, k = [], 0
    for _ in range(3):
        items = []
        for _ in range(rng.randint(3, 7)):
            name = names[rng.randint(len(names))]
            n_res = 32 if two_buckets and name.startswith("BBBB") else 16
            items.append(_item(name, float(rng.randn()), n_res, float(k)))
            k += 1
        out.append(items)
    return out


BUFFER_CASES = {
    "fixed_100": dict(fixed_length=100),
    "epoch_order": dict(fixed_length=None),
    "reset": dict(fixed_length=100, reset_buffer=True),
    "per_couple_decay": dict(fixed_length=8, max_complexes_per_couple=2, buffer_decay=0.5),
    "temperature": dict(fixed_length=16, temperature=3.0, max_complexes_per_couple=3),
    "two_buckets": dict(fixed_length=16, temperature=0.5),
    "two_buckets_epoch_order": dict(fixed_length=None),
}


@pytest.mark.parametrize("case", sorted(BUFFER_CASES))
def test_buffer_and_offline_dataset_pick_what_jax_picks(case):
    """Three add rounds, then batches, single draws and statistics after
    each: the same items in the same order, the same bucket per batch; the
    BootstrappingDataset over the last round's items draws the same ones."""
    kw = BUFFER_CASES[case]
    rounds = _rounds(two_buckets=case.startswith("two_buckets"))
    ligands = sorted({n for r in rounds for _, n, _ in r})
    bufs = [mod.CBBuffer(cluster_ligands=ligands, **kw) for mod in (jbuffer, buffer)]
    ident = lambda padded: float(padded["lig_pos"][0, 0])
    for items in rounds:
        for b in bufs:
            b.add_complexes(items)
        (jb, tb) = bufs
        assert tb.statistics() == jb.statistics() and len(tb) == len(jb)
        assert [(c.name, c.confidence, c.iteration, ident(c.padded)) for c in tb.complexes] == \
            [(c.name, c.confidence, c.iteration, ident(c.padded)) for c in jb.complexes]
        for size in (4, 5):
            picks = [[(ident(p), p["rec_pos"].shape) for p in b.sample_batch(size)] for b in bufs]
            assert picks[0] == picks[1] and len(picks[1]) == size
            assert len({s for _, s in picks[1]}) == 1  # one bucket a batch
        assert [ident(tb.get(i)) for i in range(6)] == [ident(jb.get(i)) for i in range(6)]
    sets = [mod.BootstrappingDataset(rounds[-1], temperature=kw.get("temperature", 1.0), multiplicity=2, seed=3)
            for mod in (joffline, offline_dataset)]
    assert len(sets[1]) == len(sets[0]) and np.array_equal(sets[1].weights, sets[0].weights)
    assert [ident(sets[1].get(i)) for i in range(10)] == [ident(sets[0].get(i)) for i in range(10)]


# ----------------------------------------------------------------------------- one rollout round


def _port_molecule(mol):
    return tcg.Molecule(np.asarray(mol.atomic_nums), np.asarray(mol.pos), list(mol.bonds), np.asarray(mol.charges),
                        mol.name)


@functools.lru_cache(maxsize=None)
def _targets():
    """Two CB targets per package: the small all-atom 1a0q complex under two
    names, with the cache's molecule (8 automorphisms)."""
    _, hc = small_complex()
    mol = tcg.load_host_cache(PKL)[1]
    jmol = JaxMolecule(np.asarray(mol.atomic_nums), np.asarray(mol.pos), list(mol.bonds), np.asarray(mol.charges),
                       mol.name)
    jt, tt = [], []
    for name in ("AAAA_1", "BBBB_1"):
        h = hc._replace(name=name)
        jt.append(jft.CBTarget(h, jmol, lm_dim=LM))
        tt.append(finetune.CBTarget(tcg.HostComplex(**h._asdict()), _port_molecule(jmol), lm_dim=LM))
    for a, b in zip(jt, tt):
        assert tuple(a.bucket) == tuple(b.bucket) and a.bucket.A == 512
        assert all(np.array_equal(v, a.padded[k]) for k, v in b.padded.items())  # the JAX dict has SVGD's fields too
    return jt, tt


def _poses(seed):
    """Per target N_POSES poses of the padded ligand: the crystal pose moved
    rigidly by 0.3-4 A (RMSDs spread across 2 A), [N_POSES, L_pad, 3]."""
    jt, _ = _targets()
    rng = np.random.RandomState(seed)
    out = []
    for t in jt:
        base = t.padded["lig_pos"].copy()
        L = len(t.hc.lig_f)
        base[:L] = t.hc.orig_lig_pos
        shift = rng.randn(N_POSES, 1, 3) * np.linspace(0.3, 4.0, N_POSES)[:, None, None] / np.sqrt(3)
        out.append((base[None] + shift).astype(np.float32))
    return out


def _stub_samplers(monkeypatch, seed, fail_on=()):
    """Both packages' samplers replaced by the same injected poses, target
    after target; the calls in ``fail_on`` raise instead."""
    poses = _poses(seed)
    calls = {"jax": 0, "port": 0}

    def stub(which, to_array, batch):
        i = calls[which]
        calls[which] += 1
        if i in fail_on:
            raise ValueError(f"injected failure at call {i}")
        return batch.replace(lig_pos=to_array(poses[i % len(poses)])), None

    monkeypatch.setattr(jsampling, "sample_jit",
                        lambda model, variables, batch, key, model_cfg, cfg: stub("jax", jnp.asarray, batch))
    monkeypatch.setattr(sampling, "sample",
                        lambda model, batch, model_cfg, cfg, generator=None, device=None, mesh=None:
                        stub("port", torch.as_tensor, batch))


@functools.lru_cache(maxsize=None)
def _confidence_fns():
    """The CLI's confidence function in each package (replicate the target,
    set the poses, ``score_confidence``), the ns=8 all-atom confidence
    model with the port's seeded weights in both (the JAX call jitted)."""
    model = taam.AllAtomScoreModel(config.confidence_model_config(**SMALL), device="cpu", seed=1)
    # seeded weights score these poses within 1e-3 of each other: the head's
    # last layer scaled by 1e3 and centred spreads them over about 1
    head = model.confidence_predictor.layers[-1]
    with torch.no_grad():
        head.weight.mul_(1e3)
        conf = [sampling.score_confidence(model, tcg.replicate_complex(t.padded, N_POSES, device="cpu"),
                                          lig_pos=torch.as_tensor(p)) for t, p in zip(_targets()[1], _poses(0))]
        head.bias.sub_(torch.cat(conf).mean())
    variables = from_flax.flax_from_state_dict(model)
    jmodel = jaam.AllAtomScoreModel(jax_confidence_config(**dict(SMALL, dropout=0.0)))
    score = jax.jit(functools.partial(jsampling.score_confidence, jmodel))

    def jax_fn(target, poses):
        batch = jft.replicate_complex(target.padded, len(poses))
        lp = batch.lig_pos.at[:, : poses.shape[1]].set(poses)
        return np.asarray(score(variables, batch, lig_pos=lp))

    def port_fn(target, poses):
        batch = tcg.replicate_complex(target.padded, len(poses), device=poses.device)
        lp = batch.lig_pos.clone()
        lp[:, : poses.shape[1]] = poses
        return sampling.score_confidence(model, batch, lig_pos=lp)

    return jax_fn, port_fn


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=atol)


def _same_round(got, want, conf_atol):
    (tk, tm), (jk, jm) = got, want
    assert [n for _, n, _ in tk] == [n for _, n, _ in jk]
    _close([c for _, _, c in tk], [c for _, _, c in jk], conf_atol)
    for (ti, _, _), (ji, _, _) in zip(tk, jk):
        assert set(ti) <= set(ji) and all(np.array_equal(v, ji[k]) for k, v in ti.items())
    assert set(tm) == set(jm)
    for k in ("n_sampled", "n_kept", "failures", "rmsds_lt2", "rmsds_lt5", "kept_rmsds_lt2"):
        assert tm[k] == jm[k], k
    _close(tm["kept_rmsds"], jm["kept_rmsds"], RMSD_ATOL)
    _close(tm["mean_rmsd"], jm["mean_rmsd"], RMSD_ATOL)
    _close(tm["mean_confidence"], jm["mean_confidence"], conf_atol)
    assert all(tm[k] >= 0 for k in ("wall_rollout", "wall_rmsd", "wall_confidence"))


def _round_both(kind, cb_kw, fail_on=(), seed=0, monkeypatch=None):
    _stub_samplers(monkeypatch, seed, fail_on)
    jt, tt = _targets()
    jfn, tfn = _confidence_fns() if kind == "model" else (None, None)
    cb = dict(inference_samples=N_POSES, oracle_confidence=kind == "oracle", **cb_kw)
    jcfg = jconfig.ScoreModelConfig(lm_embedding_dim=LM)
    tcfg = config.ScoreModelConfig(lm_embedding_dim=LM)
    want = jft.inference_epoch(None, None, jt, jax.random.PRNGKey(0), jcfg, jconfig.CBConfig(**cb), jfn)
    got = finetune.inference_epoch(None, tt, torch.Generator().manual_seed(0), tcfg, config.CBConfig(**cb), tfn,
                                   device="cpu")
    return got, want


@pytest.mark.parametrize("kind,cutoff", [("oracle", -2.0), ("model", None), ("none", -0.5), ("none", 0.0)])
def test_inference_epoch_matches_jax(kind, cutoff, monkeypatch):
    """The same kept items (poses bit for bit), the same counts and metrics.
    The model's cutoff sits halfway across the widest gap between its
    confidences in their middle half, far from every pose's confidence."""
    cb_kw = {}
    if kind == "model":
        jfn, _ = _confidence_fns()
        conf = np.sort(np.concatenate([jfn(t, jnp.asarray(p[:, : len(t.hc.lig_f)]))
                                       for t, p in zip(_targets()[0], _poses(0))]))
        gaps = np.diff(conf)[len(conf) // 4: 3 * len(conf) // 4]
        i = int(np.argmax(gaps)) + len(conf) // 4
        cb_kw["confidence_cutoff"] = float(conf[i] + conf[i + 1]) / 2
        assert gaps.max() > 20 * REL * max(1.0, np.abs(conf).max())
    else:
        cb_kw["confidence_cutoff"] = cutoff
    got, want = _round_both(kind, cb_kw, monkeypatch=monkeypatch)
    scale = max(1.0, max((abs(c) for _, _, c in want[0]), default=1.0))
    _same_round(got, want, RMSD_ATOL if kind == "oracle" else REL * scale)
    assert want[1]["n_sampled"] == 2 * N_POSES
    if kind != "none" or cutoff < 0:
        assert 0 < want[1]["n_kept"] <= 2 * N_POSES
    if kind != "none":
        assert 0 < want[1]["n_kept"] < 2 * N_POSES  # the cutoff keeps some and drops some
    if kind == "oracle":
        assert 0 < want[1]["rmsds_lt2"] < 1


@pytest.mark.parametrize("limit,fail_on", [(1, (0,)), (2, (0, 1)), (0, (1,)), (1, (0, 1))])
def test_inference_epoch_skips_failures_as_jax_does(limit, fail_on, monkeypatch, capsys):
    """A target whose sample raises is skipped and counted; one failure more
    than ``limit_failures`` raises, in both packages."""
    cb_kw = dict(confidence_cutoff=-2.0, limit_failures=limit)
    if len(fail_on) > limit:
        for run in ("jax", "port"):
            _stub_samplers(monkeypatch, 0, fail_on)
            jt, tt = _targets()
            with pytest.raises(ValueError, match="injected failure"):
                if run == "jax":
                    jft.inference_epoch(None, None, jt, jax.random.PRNGKey(0), jconfig.ScoreModelConfig(lm_embedding_dim=LM),
                                        jconfig.CBConfig(oracle_confidence=True, **cb_kw), None)
                else:
                    finetune.inference_epoch(None, tt, torch.Generator(), config.ScoreModelConfig(lm_embedding_dim=LM),
                                             config.CBConfig(oracle_confidence=True, **cb_kw), device="cpu")
        return
    got, want = _round_both("oracle", cb_kw, fail_on=fail_on, monkeypatch=monkeypatch)
    _same_round(got, want, RMSD_ATOL)
    assert got[1]["failures"] == len(fail_on) and got[1]["n_sampled"] == N_POSES * (2 - len(fail_on))
    assert capsys.readouterr().out.count("inference failed on") == 2 * len(fail_on)


# ----------------------------------------------------------------------------- the loop


@pytest.mark.parametrize("cb_kw", [dict(), dict(lr=3e-4, batch_size=4, minimum_t=0.2, sampling_mixing_coeff=0.3,
                                                sampling_alpha=1.5, sampling_beta=0.5)])
def test_finetune_train_config_is_the_one_jax_builds(cb_kw, monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def capture(variables, cfg):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(jft.train_loop, "init_train_state", capture)
    with pytest.raises(Stop):
        jft.inference_finetune(None, {}, [], None, jconfig.CBConfig(**cb_kw), None)
    got = finetune.finetune_config(config.CBConfig(**cb_kw))
    assert_port_fields(config.to_dict(got), jconfig.to_dict(seen[0]), jconfig.to_dict(jconfig.TrainConfig()), every=False)


SMALL_SCORE = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=16, dropout=0.0)


def _state_snapshot(state):
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {n: b.clone() for n, b in state.model.named_buffers()},
            {n: e.clone() for n, e in state.ema.items()},
            {id(p): {k: v.clone() for k, v in s.items()} for p, s in state.optimizer.state.items()},
            state.step)


def _same_snapshot(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert a[3].keys() == b[3].keys()
    assert all(torch.equal(a[3][p][k], b[3][p][k]) for p in a[3] for k in a[3][p])
    assert a[4] == b[4]


def test_inference_finetune_two_epochs(tmp_path, monkeypatch):
    """Two epochs, a rollout round each (oracle confidence, keep all), two
    fine-tune steps an epoch. Each rollout runs a second model holding the
    EMA parameters (each moved by its own copy, so kernels repack) and the
    training model's buffers; the round leaves the training model, its
    optimizer and its EMA bit for bit. The workdir's msgpack files load in
    the JAX package against its own model's template, equal to the port's
    weights and to its EMA with the buffers."""
    install_jax_tables(monkeypatch)
    jtargets = [_synthetic_target("AAAA_1", 0), _synthetic_target("BBBB_1", 1)]
    targets = [finetune.CBTarget(tcg.HostComplex(**t.hc._asdict()), _port_molecule(t.mol), lm_dim=16)
               for t in jtargets]
    cfg = config.ScoreModelConfig(**SMALL_SCORE)
    model = TensorProductScoreModel(cfg, device="cpu", seed=0)
    cb = config.CBConfig(n_epochs=2, cb_inference_freq=1, inference_samples=2, inference_steps=2, initial_iterations=1,
                         inference_iterations=1, confidence_cutoff=-1000.0, oracle_confidence=True, fixed_length=4,
                         batch_size=2, max_complexes_per_couple=None)
    seen = {"roll": [], "rounds": 0}
    real_weights, real_epoch = finetune.rollout_weights, finetune.inference_epoch

    def rollout_weights(roll, state, use_ema=True):
        versions = [p._version for p in roll.parameters()]
        out = real_weights(roll, state, use_ema)
        assert all(p._version > v for p, v in zip(roll.parameters(), versions))  # TPConv.packed_weights repacks
        seen["roll"].append((roll, state))
        return out

    def inference_epoch(roll, *a, **k):
        state = seen["roll"][-1][1]
        assert roll is seen["roll"][-1][0] and roll is not state.model
        assert not any(p.requires_grad for p in roll.parameters())
        assert all(torch.equal(p, state.ema[n]) for n, p in roll.named_parameters())
        train_buffers = dict(state.model.named_buffers())
        assert all(torch.equal(b, train_buffers[n]) for n, b in roll.named_buffers())
        before = _state_snapshot(state)
        out = real_epoch(roll, *a, **k)
        _same_snapshot(_state_snapshot(state), before)
        seen["rounds"] += 1
        return out

    monkeypatch.setattr(finetune, "rollout_weights", rollout_weights)
    monkeypatch.setattr(finetune, "inference_epoch", inference_epoch)
    state, history = finetune.inference_finetune(model, targets, cfg, cb, torch.Generator().manual_seed(1),
                                                 workdir=str(tmp_path), device="cpu")
    assert seen["rounds"] == 2 and state.model is model and state.step == 4
    assert len(history) == 2 and [h["epoch"] for h in history] == [0, 1]
    assert history[0]["inference"]["n_sampled"] == 4 and history[0]["inference"]["n_kept"] == 4
    assert history[1]["buffer"]["size"] == 8 and np.isfinite(history[-1]["train"]["loss"])
    assert set(os.listdir(tmp_path)) == {"last_model.msgpack", "ema_model.msgpack", "metrics.pkl",
                                         "final_filtered_rmsds.npy"}
    assert len(np.load(tmp_path / "final_filtered_rmsds.npy")) == 8
    assert any(not torch.equal(e, p) for e, p in zip(state.ema.values(), model.parameters()))

    jmodel = JaxModel(jconfig.ScoreModelConfig(**SMALL_SCORE))
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jft.replicate_complex(jtargets[0].padded, 1))
    for name, params in (("last_model", None), ("ema_model", state.ema)):
        got = jax.tree.map(np.asarray, jckpt.load_params(str(tmp_path / f"{name}.msgpack"), template))
        want = from_flax.flax_from_state_dict(model, params)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def test_generate_bootstrapping_complexes_cache_round_trip(tmp_path, monkeypatch):
    """Rollout and filter into complexes_id<N>.pkl; the second call reads the
    cache (it samples nothing) and gives the same items."""
    install_jax_tables(monkeypatch)
    jt = _synthetic_target("AAAA_1", 0)
    target = finetune.CBTarget(tcg.HostComplex(**jt.hc._asdict()), _port_molecule(jt.mol), lm_dim=16)
    cfg = config.ScoreModelConfig(**SMALL_SCORE)
    model = TensorProductScoreModel(cfg, device="cpu", seed=0)
    conf = lambda t, poses: -torch.linalg.norm(poses.mean(1) - torch.as_tensor(t.hc.orig_lig_pos.mean(0)), dim=-1)
    args = dict(samples_per_target=3, inference_steps=2, confidence_fn=conf, confidence_cutoff=-1e9,
                cache_path=str(tmp_path), cache_id="7", device="cpu")
    kept = offline_dataset.generate_bootstrapping_complexes(model, [target], torch.Generator().manual_seed(0), cfg, **args)
    assert os.path.exists(tmp_path / "complexes_id7.pkl") and len(kept) == 3
    L = len(target.hc.lig_f)
    assert all(n == "AAAA_1" and np.isfinite(c) and not np.array_equal(p["lig_pos"][:L], target.padded["lig_pos"][:L])
               for p, n, c in kept)
    monkeypatch.setattr(sampling, "sample", lambda *a, **k: pytest.fail("read from the cache, not sampled"))
    again = offline_dataset.generate_bootstrapping_complexes(None, [target], None, cfg, **args)
    assert [(n, c) for _, n, c in again] == [(n, c) for _, n, c in kept]
    assert all(p.keys() == q.keys() and all(np.array_equal(p[k], q[k]) for k in p) for (p, _, _), (q, _, _) in zip(again, kept))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cb = config.CBConfig()
    cfg = config.ScoreModelConfig()
    for call in (lambda: finetune.inference_epoch(None, [], None, cfg, cb),
                 lambda: finetune.inference_finetune(None, [], cfg, cb, None),
                 lambda: offline_dataset.generate_bootstrapping_complexes(None, [], None, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_import_guard_walks_the_new_modules():
    """test_port_never_imports_jax imports every module ``pkgutil`` finds
    in the port: the CB loop's and the training remainder's are among them."""
    import pkgutil

    import confidence_bootstrapping_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for mod in ("bootstrapping", "bootstrapping.buffer", "bootstrapping.finetune", "bootstrapping.offline_dataset",
                "train.train_loop", "train.checkpoints"):
        assert f"{pkg.__name__}.{mod}" in names, mod
