"""The port's training CLIs (``cli/train``, ``cli/bootstrap_gen``,
``cli/finetune``, ``cli/confidence_train``) on the CPU, in the scenarios of
the JAX CLIs' tests (JAX ``tests/test_cli_train.py``,
``tests/test_bootstrapping.py:118-205``, ``tests/test_confidence.py:
260-338``), at tiny models (ns=8, nv=2, one or two trunk layers) on the JAX
tests' toy complexes.

* Workdirs: the JAX CLIs' file names (checked against the JAX CLI's
  source); the port's bundles read by the JAX package's ``checkpoints``
  loaders (weights exactly, the train-state bundle at its epoch); a JAX
  workdir resumed by the port (``--restart_dir``: the bundle's state
  exactly, at the next epoch; weights only; ``--restart_lr``) and a
  torsional-pretrained workdir loaded by ``--pretrain_dir``; ``history.pkl``
  of plain Python numbers.
* ``inference_benchmark`` on injected poses: the JAX CLI's metrics,
  within 1e-6.
* ``transfer_matching_variables``: what the JAX function copies, by Flax
  path, the same count.
* ``--data_parallel`` over two gloo ranks (tests/torch_parallel_worker.py):
  ``train`` against one process step by step (the losses before any
  update, each step's gradients, the parameters each step leaves, the
  losses after an update against the one process's own spread) and rank 0
  alone writes the workdir; ``finetune`` keeps 8 poses and both ranks hold
  the same buffer and parameters.
* No CLI runs without a card unless ``--device cpu`` is given.
"""

import inspect
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from confidence_bootstrapping_tpu.cli import confidence_train as jconf_cli
from confidence_bootstrapping_tpu.cli import train as jtrain_cli
from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig, TrainConfig as JaxTrainConfig
from confidence_bootstrapping_tpu.config import load_score_config as jax_load_score_config
from confidence_bootstrapping_tpu.data import dataset as jdataset
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu.train import checkpoints as jckpt, train_loop as jtl
from confidence_bootstrapping_tpu_torch.cli import bootstrap_gen, confidence_train, finetune, train
from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig, save_yaml
from confidence_bootstrapping_tpu_torch.data import dataset
from confidence_bootstrapping_tpu_torch.data.conformers import mol_from_smiles
from confidence_bootstrapping_tpu_torch.data.mol_io import write_sdf
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.factory import get_model
from confidence_bootstrapping_tpu_torch.sampler import sampling
from confidence_bootstrapping_tpu_torch.train import checkpoints, diffusion, train_loop
from test_datasets import _write_toy_complex_dir
from test_torch_common import install_jax_tables
from torch_parallel_worker import captured_gradients, run_ranks

TINY = dict(ns=8, nv=2, num_conv_layers=1, num_prot_emb_layers=1, lm_embedding_dim=0, dropout=0.0)
# of max |g| of a tensor: the gradient comparison's own tolerance. An element within it of zero may take either
# sign over two ranks and pass that comparison, and Adam's first step turns its sign into +-lr.
ROUNDING_FLOOR = 1e-4
# what the JAX train CLI writes at --val_inference_freq 1 --save_model_freq 1 --inference_secondary_metric
TRAIN_FILES = ["best_ema_inference_epoch_model.msgpack", "best_ema_model.msgpack",
               "best_ema_secondary_epoch_model.msgpack", "best_inference_epoch_model.msgpack", "best_model.msgpack",
               "epoch0_model.msgpack", "history.pkl", "last_ema_model.msgpack", "last_model.msgpack",
               "last_state.msgpack", "model_config.yml"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    for i, name in enumerate(("aaaa", "bbbb")):
        _write_toy_complex_dir(str(root / "data"), name, seed=i, n_res=10)
    (root / "tiny.yml").write_text(yaml.dump(TINY))
    for name, cfg in (("score", ScoreModelConfig(**TINY)),
                      ("conf", ScoreModelConfig(**TINY, all_atoms=True, confidence_mode=True))):
        os.makedirs(root / name)
        save_yaml(cfg, str(root / name / checkpoints.CONFIG_NAME))  # no weights: random, with a warning
    mols = root / "mols"
    os.makedirs(mols)
    for i, smi in enumerate(("CCCCO", "CC(C)Cc1ccccc1", "OCCN(C)CC", "CCOC(=O)CCN")):
        mol = mol_from_smiles(smi, seed=i)
        write_sdf(mol, mol.pos, str(mols / f"m{i}.sdf"))
    return root


def _train_argv(files, wd, *extra, matching=False):
    return ["--data_dir", str(files / "data"), "--cache_path", str(files / "cache"), "--workdir", str(wd),
            "--config", str(files / "tiny.yml"), "--batch_size", "2", *([] if matching else ["--no_matching"]),
            *extra, "--device", "cpu"]


def _jax_template(model, cfg=JaxTrainConfig()):
    v = from_flax.flax_from_state_dict(model)
    return v, jtl.init_train_state(jax.tree.map(np.zeros_like, v), cfg)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _floats_only(x) -> bool:
    if isinstance(x, dict):
        return all(_floats_only(v) for v in x.values())
    if isinstance(x, list):
        return all(_floats_only(v) for v in x)
    return type(x) in (float, int)


def test_train_cli_workdir_and_restart(files, tmp_path, monkeypatch, capsys):
    """Two epochs with the benchmark each epoch and conformer matching on:
    the JAX CLI's files, read by the JAX package; then --restart_dir resumes
    at epoch 2 with --restart_lr, and --wandb prints that it is unavailable."""
    install_jax_tables(monkeypatch)
    src = inspect.getsource(jtrain_cli)
    for f in TRAIN_FILES:
        stem = f.rsplit(".", 1)[0].replace("epoch0_", "epoch{epoch}_")
        assert f'"{stem}' in src or stem in ("last_state", "model_config"), stem
    assert checkpoints.CONFIG_NAME == jckpt.CONFIG_NAME and checkpoints.STATE_NAME == jckpt.STATE_NAME
    wd = tmp_path / "wd"
    state, history = train.main(_train_argv(files, wd, "--n_epochs", "2", "--val_inference_freq", "1",
                                            "--inference_steps", "2", "--inference_samples", "2",
                                            "--save_model_freq", "2", "--inference_secondary_metric",
                                            "valinf_rmsds_lt5", "--matching_popsize", "4", "--matching_maxiter",
                                            "3", matching=True))
    names = sorted(os.listdir(wd))
    assert names == sorted(f.replace("epoch0", "epoch1") for f in TRAIN_FILES)
    with open(wd / "history.pkl", "rb") as f:
        hist = pickle.load(f)
    assert [h["epoch"] for h in hist] == [0, 1] and _floats_only(hist) and "inference" in hist[0]
    assert np.isfinite(hist[-1]["train"]["loss"]) and state.step == 2
    # the JAX package's loaders take the workdir
    assert jax_load_score_config(str(wd / checkpoints.CONFIG_NAME)) == JaxScoreConfig(**TINY)
    v, tmpl = _jax_template(state.model)
    for name, params in (("last_model", None), ("last_ema_model", state.ema)):
        got = jckpt.load_params(str(wd / f"{name}.msgpack"), v)
        want = from_flax.flax_from_state_dict(state.model, params)
        assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(want))), name
    jstate, epoch = jckpt.load_train_state(str(wd), tmpl)
    assert epoch == 1 and int(jstate.step) == 2
    capsys.readouterr()
    state2, hist2 = train.main(_train_argv(files, tmp_path / "wd2", "--n_epochs", "3", "--val_inference_freq", "0",
                                           "--restart_dir", str(wd), "--restart_lr", "1e-5", "--wandb"))
    out = capsys.readouterr().out
    assert "resuming at epoch 2" in out and "wandb unavailable" in out
    assert [h["epoch"] for h in hist2] == [2] and state2.step == 3 and state2.lr_scale == pytest.approx(1e-2)


def test_train_cli_resumes_a_jax_workdir(files, tmp_path):
    """A workdir the JAX package wrote (its train-state bundle at epoch 4,
    weights, config): --restart_dir resumes at epoch 5 with the bundle's
    state exactly (--n_epochs 5 leaves no epoch to run); without the bundle,
    the weights with EMA = weights."""
    src_model = get_model(ScoreModelConfig(**TINY), device="cpu", seed=3)
    st = train_loop.init_train_state(src_model, TrainConfig())
    train_loop.apply_gradients(st, [torch.randn_like(p) for p in src_model.parameters()], torch.tensor(True),
                               TrainConfig())
    v, tmpl = _jax_template(src_model)
    jstate = tmpl._replace(params=v["params"], batch_stats=v["batch_stats"],
                           ema_params=from_flax.flax_tree(src_model, st.ema), step=np.asarray(7, np.int32),
                           lr_scale=np.asarray(0.5, np.float32))
    jd = tmp_path / "jax"
    jckpt.save_model_dir(str(jd), JaxScoreConfig(**TINY), v)
    jckpt.save_train_state(str(jd), jstate, epoch=4)
    state, history = train.main(_train_argv(files, tmp_path / "wd", "--n_epochs", "5", "--restart_dir", str(jd)))
    assert history == [] and state.step == 7 and state.lr_scale == 0.5
    for n, p in state.model.named_parameters():
        assert torch.equal(p, dict(src_model.named_parameters())[n]) and torch.equal(state.ema[n], st.ema[n]), n
    os.remove(jd / f"{jckpt.STATE_NAME}.msgpack")
    state, history = train.main(_train_argv(files, tmp_path / "wd", "--n_epochs", "0", "--restart_dir", str(jd)))
    assert state.step == 0
    for n, p in state.model.named_parameters():
        assert torch.equal(p, dict(src_model.named_parameters())[n]) and torch.equal(state.ema[n], p), n


def test_torsional_pretraining_workdir_loads_in_both(files, tmp_path, monkeypatch):
    """--dataset torsional (no --data_dir): a workdir whose weights the JAX
    package's load_params takes, and which --pretrain_dir loads exactly."""
    install_jax_tables(monkeypatch)
    wd = tmp_path / "tors"
    state, history = train.main(["--dataset", "torsional", "--torsional_data_dir", str(files / "mols"), "--workdir",
                                 str(wd), "--config", str(files / "tiny.yml"), "--batch_size", "2", "--n_epochs", "1",
                                 "--device", "cpu"])
    assert sorted(history[0]["train"]) == ["loss", "skipped", "tor_base_loss"] and np.isfinite(history[0]["val"]["loss"])
    assert "inference" not in history[0] and {"last_model.msgpack", "last_state.msgpack"} <= set(os.listdir(wd))
    v, _ = _jax_template(state.model)
    got = jckpt.load_params(str(wd / "last_model.msgpack"), v)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(from_flax.flax_from_state_dict(state.model))))
    pre, hist = train.main(_train_argv(files, tmp_path / "wd", "--n_epochs", "0", "--pretrain_dir", str(wd)))
    assert hist == [] and all(torch.equal(p, dict(state.model.named_parameters())[n])
                              for n, p in pre.model.named_parameters())


def test_inference_benchmark_matches_jax_on_injected_poses(files, monkeypatch):
    """Poses at 0.5-4 A from the crystal pose, injected into both packages'
    samplers: the same metrics."""
    entries = dataset.discover_dir(str(files / "data"))
    ds = dataset.ComplexDataset(entries, cache_dir=str(files / "cache"))
    jds = jdataset.ComplexDataset(entries, cache_dir=str(files / "cache"))
    rng = np.random.RandomState(0)
    poses = {hc.name: hc.orig_lig_pos[None] + rng.randn(3, *hc.orig_lig_pos.shape) * s
             for hc, s in zip(ds.complexes, (0.5, 2.5))}
    calls = []

    def inject(batch):
        name = ds.complexes[len(calls)].name
        calls.append(name)
        p = np.array(batch.lig_pos)
        p[:, : poses[name].shape[1]] = poses[name]
        return p

    monkeypatch.setattr(sampling, "sample", lambda model, b, *a, **k: (b.replace(lig_pos=torch.as_tensor(inject(b))),
                                                                       None))
    got = train.inference_benchmark(None, ds, ScoreModelConfig(**TINY), 2, 3, 2, torch.Generator(), "cpu")
    calls.clear()
    monkeypatch.setattr(jsampling, "sample_jit", lambda model, v, b, *a, **k: (b.replace(lig_pos=inject(b)), None))
    want = jtrain_cli.inference_benchmark(None, None, jds, JaxScoreConfig(**TINY), 2, 3, 2, jax.random.PRNGKey(0))
    assert got.keys() == want.keys() and 0 < got["valinf_rmsds_lt2"] < 1
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_bootstrap_gen_then_train_on_its_pickle(files, tmp_path, monkeypatch):
    """JAX tests/test_bootstrapping.py:170-205: the pickle under the JAX
    file name with every pose above the cutoff, then one training epoch
    with it mixed in."""
    install_jax_tables(monkeypatch)
    cache = tmp_path / "cache"
    kept = bootstrap_gen.main(["--data_dir", str(files / "data"), "--cache_path", str(cache), "--model_dir",
                               str(files / "score"), "--samples_per_target", "2", "--inference_steps", "2",
                               "--confidence_cutoff", "-1", "--limit_complexes", "1", "--device", "cpu"])
    out = cache / "complexes_id1.pkl"
    with open(out, "rb") as f:
        assert len(pickle.load(f)) == len(kept) == 2
    assert [(name, conf) for _, name, conf in kept] == [("aaaa", 0.0)] * 2  # no confidence model: confidence 0
    _, hist = train.main(_train_argv(files, tmp_path / "wd", "--n_epochs", "1", "--val_inference_freq", "0",
                                     "--add_bootstrapping_dataset", str(out)))
    assert np.isfinite(hist[-1]["train"]["loss"])


def test_finetune_cli_with_all_atom_confidence(files, tmp_path, monkeypatch):
    """JAX tests/test_bootstrapping.py:118-167 through the port's CLI, with a
    --config overlay: the loop's workdir, read by the JAX package."""
    install_jax_tables(monkeypatch)
    (tmp_path / "cb.yml").write_text(yaml.dump({"fixed_length": 2, "use_ema_for_rollouts": False}))
    wd = tmp_path / "wd"
    state, history = finetune.main(["--data_dir", str(files / "data"), "--cache_path", str(files / "cache"),
                                    "--workdir", str(wd), "--model_dir", str(files / "score"),
                                    "--confidence_model_dir", str(files / "conf"), "--n_epochs", "1",
                                    "--inference_samples", "2", "--inference_steps", "2", "--confidence_cutoff",
                                    "-1000", "--initial_iterations", "1", "--inference_iterations", "1",
                                    "--batch_size", "2", "--config", str(tmp_path / "cb.yml"), "--limit_complexes",
                                    "1", "--no_matching", "--device", "cpu"])
    assert len(history) == 1 and history[0]["buffer"]["size"] == 2 and np.isfinite(history[0]["train"]["loss"])
    assert {"last_model.msgpack", "ema_model.msgpack", "metrics.pkl"} <= set(os.listdir(wd))
    args = finetune.get_parser().parse_args(["--data_dir", "x", "--config", str(tmp_path / "cb.yml")])
    assert finetune.cb_config(args).fixed_length == 2 and not finetune.cb_config(args).use_ema_for_rollouts
    v, _ = _jax_template(state.model)
    got = jckpt.load_params(str(wd / "ema_model.msgpack"), v)
    want = from_flax.flax_from_state_dict(state.model, state.ema)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def test_confidence_train_cli_transfer_cache_and_test(files, tmp_path, monkeypatch):
    """JAX tests/test_confidence.py:260-372: --cache_creation_id writes a
    cache and exits; --transfer_weights trains (the JAX CLI's workdir files,
    its config read by the JAX package); --test sweeps steps 0..T."""
    install_jax_tables(monkeypatch)
    wd = tmp_path / "wd"
    base = ["--data_dir", str(files / "data"), "--cache_path", str(tmp_path / "cache"), "--workdir", str(wd),
            "--original_model_dir", str(files / "score"), "--samples_per_complex", "2", "--inference_steps", "2",
            "--limit_complexes", "1", "--device", "cpu"]
    assert confidence_train.main(base + ["--cache_creation_id", "7"]) is None
    assert os.listdir(tmp_path / "cache" / "confidence_generation") == ["confidence_cache_id7_s2_T2.pkl"]
    state, history = confidence_train.main(base + ["--n_epochs", "1", "--batches_per_epoch", "2", "--batch_size", "2",
                                                   "--transfer_weights", "--cache_ids", "7"])
    assert sorted(os.listdir(wd)) == ["ema_model.msgpack", "history.pkl", "last_model.msgpack", "model_config.yml"]
    assert jax_load_score_config(str(wd / checkpoints.CONFIG_NAME)) == JaxScoreConfig(**TINY, confidence_mode=True)
    assert np.isfinite(history[0]["train"]["loss"]) and "val" in history[0]
    # the CLI's own architecture (all-atom, lmax=2) at the targets' ESM width (none), loaded back strictly
    wd2 = tmp_path / "wd2"
    confidence_train.main([a if a != str(wd) else str(wd2) for a in base]
                          + ["--n_epochs", "1", "--batches_per_epoch", "1", "--batch_size", "2", "--ns", "8", "--nv",
                             "2", "--cache_ids", "7"])
    model, cfg = load_or_init_model(str(wd2), "last_model", device="cpu")
    assert cfg.all_atoms and cfg.sh_lmax == 2 and cfg.lm_embedding_dim == 0 and cfg.ns == 8
    sweep = confidence_train.main(base + ["--test", "--all_atoms"])
    assert [r["step"] for r in sweep] == [0, 1, 2] and all(np.isfinite(r["mean_rmsd"]) for r in sweep)
    assert os.path.exists(wd / "trajectory_sweep.json")


def test_confidence_train_cli_affinity_heads(files, tmp_path, monkeypatch):
    """--affinity_prediction with --affinity_csv labels: --parallel 2 trains
    the legacy all-atom model's grouped-pose affinity head, --transfer_weights
    the residue-level model with its affinity column; both workdirs load back
    and report the affinity validation metrics."""
    install_jax_tables(monkeypatch)
    csv = tmp_path / "affinity.csv"
    csv.write_text("# complex,affinity\n" + "".join(f"{n},{5.0 + i}\n" for i, n in enumerate(sorted(
        os.listdir(files / "data")))))
    base = ["--data_dir", str(files / "data"), "--cache_path", str(tmp_path / "cache"), "--original_model_dir",
            str(files / "score"), "--samples_per_complex", "2", "--inference_steps", "2", "--limit_complexes", "1",
            "--device", "cpu", "--n_epochs", "1", "--batches_per_epoch", "1", "--batch_size", "2",
            "--affinity_prediction", "--affinity_csv", str(csv)]
    for wd, extra in (("legacy", ["--parallel", "2", "--ns", "8", "--nv", "2"]), ("column", ["--transfer_weights"])):
        _, history = confidence_train.main(base + ["--workdir", str(tmp_path / wd)] + extra)
        val = history[0]["val"]
        assert np.isfinite(history[0]["train"]["affinity_loss"]) and np.isfinite(val["affinity_rmse"])
        model, cfg = load_or_init_model(str(tmp_path / wd), "last_model", device="cpu")
        assert cfg.affinity_prediction and cfg.old_score_model == (wd == "legacy")
        assert (cfg.parallel, cfg.all_atoms) == ((2, True) if wd == "legacy" else (1, False))


def test_transfer_matching_variables_matches_jax():
    src = get_model(ScoreModelConfig(**TINY), device="cpu", seed=1)
    dst = get_model(ScoreModelConfig(**dict(TINY, num_conv_layers=2), confidence_mode=True), device="cpu", seed=2)
    want, n_jax = jconf_cli.transfer_matching_variables(from_flax.flax_from_state_dict(dst),
                                                        from_flax.flax_from_state_dict(src))
    n = confidence_train.transfer_matching_variables(dst, src)
    assert n == n_jax > 10
    got = from_flax.flax_from_state_dict(dst)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def test_unported_flags_and_devices_raise(files, tmp_path, monkeypatch):
    conf_base = ["--data_dir", str(files / "data"), "--original_model_dir", str(files / "score"), "--device", "cpu"]
    # the affinity flags, ported: their labels and the legacy model they need are checked before any rollout
    for flags, what in ((["--affinity_prediction"], "affinity_csv"), (["--parallel", "2"], "affinity_prediction")):
        with pytest.raises(SystemExit, match=what):
            confidence_train.main(conf_base + flags)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train.main(_train_argv(files, tmp_path)[:-2]),  # no --device
                 lambda: train.main(_train_argv(files, tmp_path, "--data_parallel")[:-2]),  # a rank's default: its card
                 lambda: finetune.main(["--data_dir", str(files / "data"), "--data_parallel"]),
                 lambda: bootstrap_gen.main(["--data_dir", str(files / "data"), "--model_dir", str(files / "score")]),
                 lambda: finetune.main(["--data_dir", str(files / "data")]),
                 lambda: confidence_train.main(conf_base[:-2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def adam_step_bound(step: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most Adam's ``step``-th update (from 1, eps 0) can move an
    element, in units of lr, over every history of gradients: the
    bias-corrected first moment over the root of the second, at its
    largest by Cauchy-Schwarz (1 at step 1, 1.0014 at step 2)."""
    w1 = [(1 - b1) * b1 ** (step - i) for i in range(1, step + 1)]
    w2 = [(1 - b2) * b2 ** (step - i) for i in range(1, step + 1)]
    return float(np.sqrt(sum(a * a / b for a, b in zip(w1, w2))) * np.sqrt(1 - b2 ** step) / (1 - b1 ** step))


def _captured_train(argv, reverse=False):
    """``train.main(argv)`` in this process with each step's gradients and
    parameters (``captured_gradients``); with ``reverse``, every batch's
    complexes in the other order, each with its own noise, so that only the
    order of the sums over the batch changes. -> (history, grads, steps)."""
    grads, steps = [], []
    with pytest.MonkeyPatch.context() as mp:
        if reverse:
            stack, draw = dataset.batch_complexes, diffusion.draw_noise
            mp.setattr(dataset, "batch_complexes", lambda items, device=None: stack(list(items)[::-1], device))
            mp.setattr(diffusion, "draw_noise",
                       lambda *a, **k: diffusion.NoiseDraws(*(x.flip(0) for x in draw(*a, **k))))
        with captured_gradients(grads, steps):
            _, history = train.main(argv)
    return history, grads, steps


def test_train_cli_data_parallel_matches_one_rank(files, tmp_path, monkeypatch):
    """Two epochs of one 2-complex batch split over two ranks against one
    process: what data parallelism promises, step by step. Epoch 0's train
    losses (before any update) within rtol 1e-4; each step's all-reduced
    gradients within 1e-4 x max |g| of each tensor; after each step every
    parameter whose one-process gradient is above its tensor's rounding
    floor (ROUNDING_FLOOR x max |g|) within atol 2.5e-3 (a step's tolerance,
    tests/test_torch_parallel.py), and every other one within twice Adam's
    largest step (lr x ``adam_step_bound``) of the one-process value, beyond
    the two runs' difference before the step: there the gradient is
    rounding noise, and Adam's first step turns its sign into +-lr. The
    losses after an update (epoch 1's train losses, the validation losses)
    within rtol 1e-4, or within 2 x the one process's own spread when the
    batch's complexes run in the other order, whichever is larger. Both
    ranks end with the same history and parameters; rank 0 alone writes the
    workdir, the one-process set of files."""
    install_jax_tables(monkeypatch)
    extra = ("--n_epochs", "2", "--val_inference_freq", "0")
    one, g_one, s_one = _captured_train(_train_argv(files, tmp_path / "one", *extra))
    argv = _train_argv(files, tmp_path / "unused", *extra, "--data_parallel")
    outs = run_ranks("cli", tmp_path / "dp", 2, dict(cli="train", argv=argv, rank_argv=[
        ["--workdir", str(tmp_path / f"wd{r}")] for r in range(2)]))
    again, _, _ = _captured_train(_train_argv(files, tmp_path / "again", *extra), reverse=True)
    lr = TrainConfig().lr
    for out in outs:
        assert [h["epoch"] for h in out["history"]] == [0, 1] and out["history"] == outs[0]["history"]
        for k, v in one[0]["train"].items():
            np.testing.assert_allclose(out["history"][0]["train"][k], v, rtol=1e-4, atol=1e-6, err_msg=("train", k))
        for epoch, part in ((0, "val"), (1, "train"), (1, "val")):
            for k, v in one[epoch][part].items():
                spread = abs(again[epoch][part][k] - v)
                tol = max(1e-6 + 1e-4 * abs(v), 2 * spread)
                assert abs(out["history"][epoch][part][k] - v) <= tol, (
                    epoch, part, k, out["history"][epoch][part][k], v, f"one process's spread {spread:.4e}")
        assert len(out["grads"]) == len(g_one) == len(out["steps"]) == len(s_one) == 2
        names = [n for n, _ in outs[0]["params"].items()]
        for step, (gd, go, (bd, ad), (bo, ao)) in enumerate(zip(out["grads"], g_one, out["steps"], s_one), 1):
            for n, *ts in zip(names, gd, go, ad, ao, bd, bo):
                a, b, pd, po, p0, q0 = (t.numpy() for t in ts)
                scale = np.abs(b).max(initial=0.0)
                assert np.abs(a - b).max(initial=0.0) <= ROUNDING_FLOOR * scale, (step, n, np.abs(a - b).max(), scale)
                if step == 1:
                    assert np.array_equal(p0, q0), n  # the same seeded weights
                above = np.abs(b) > ROUNDING_FLOOR * scale
                assert np.abs(pd - po)[above].max(initial=0.0) <= 2.5e-3, (step, n)
                # below the floor each run's update is at most lr x adam_step_bound, of either sign
                off, was = np.abs(pd - po)[~above], np.abs(p0 - q0)[~above]
                slack = 2 * np.spacing(np.abs(p0).max(initial=0.0))
                bound = was + 2 * lr * adam_step_bound(step) + slack
                assert (off <= bound).all(), (step, n, (off - bound).max(initial=0.0))
    assert sorted(os.listdir(tmp_path / "wd0")) == sorted(os.listdir(tmp_path / "one"))
    assert not os.path.exists(tmp_path / "wd1") and not os.path.exists(tmp_path / "unused")
    assert all(torch.equal(outs[0]["params"][n], outs[1]["params"][n]) for n in outs[0]["params"])


def test_finetune_cli_data_parallel(files, tmp_path, monkeypatch):
    """JAX tests/test_bootstrapping.py:207-240 over two ranks: 8 rollouts
    split 4 + 4 and gathered, all kept (oracle confidence), one fine-tune
    step of 8 split 4 + 4; both ranks hold the same buffer and weights."""
    install_jax_tables(monkeypatch)
    argv = ["--data_dir", str(files / "data"), "--cache_path", str(files / "cache"), "--model_dir",
            str(files / "score"), "--n_epochs", "1", "--inference_samples", "8", "--inference_steps", "2",
            "--oracle_confidence", "--confidence_cutoff", "-1000", "--initial_iterations", "1",
            "--inference_iterations", "1", "--batch_size", "8", "--limit_complexes", "1", "--no_matching",
            "--data_parallel", "--device", "cpu"]
    outs = run_ranks("cli", tmp_path / "dp", 2, dict(cli="finetune", argv=argv, rank_argv=[
        ["--workdir", str(tmp_path / f"wd{r}")] for r in range(2)]))
    a, b = outs
    assert len(a["history"]) == 1 and a["history"][0]["inference"]["n_kept"] == 8
    assert a["history"] == b["history"] and np.isfinite(a["history"][0]["train"]["loss"])
    assert len(a["buffer"]) == len(b["buffer"]) == a["history"][0]["buffer"]["size"] > 0  # the per-receptor cap
    for x, y in zip(a["buffer"], b["buffer"]):
        assert x[:3] == y[:3] and np.array_equal(x[3], y[3])
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    assert {"last_model.msgpack", "ema_model.msgpack", "metrics.pkl"} <= set(os.listdir(tmp_path / "wd0"))
    assert not os.path.exists(tmp_path / "wd1")


@pytest.mark.parametrize("overlay", [dict(all_atoms=True), dict(sh_lmax=2), dict(use_second_order_repr=True),
                                     dict(depthwise_convolution=True), dict(tp_weights_layers=1),
                                     dict(tp_weights_layers=3), dict(sidechain_pred=True),
                                     dict(fixed_center_conv=False)], ids=lambda o: "-".join(map(str, o.items())))
def test_train_cli_takes_the_score_model_remainder(overlay, files, tmp_path, monkeypatch):
    """``cli.train --config`` with each configuration the port refused before
    the score-model remainder (the all-atom model in score mode on all-atom
    complexes, as the JAX train CLI builds its datasets for it): one epoch,
    a finite loss, a model directory of that configuration that loads back."""
    install_jax_tables(monkeypatch)
    cfg = dict(TINY, **overlay)
    (tmp_path / "cfg.yml").write_text(yaml.dump(cfg))
    argv = _train_argv(files, tmp_path / "wd", "--n_epochs", "1")
    argv[argv.index("--config") + 1] = str(tmp_path / "cfg.yml")
    state, history = train.main(argv)
    assert len(history) == 1 and np.isfinite(history[0]["train"]["loss"])
    model, got = load_or_init_model(str(tmp_path / "wd"), "last_model", device="cpu")
    assert got == ScoreModelConfig(**{**TINY, **overlay}) == state.model.cfg
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[n]), n
