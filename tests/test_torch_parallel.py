"""The port's data parallelism (``parallel/mesh.py``) on the CPU: ranks are
subprocesses on gloo, joined through a file store in the test's directory
(``tests/torch_parallel_worker.py``), one torch thread each.

* The mesh API in one process, and over two ranks: slices, gathers,
  ``replicate``, ``make_mesh_2d``'s refusal; ``model_parallel_specs`` cuts
  the same Flax-named leaves as the JAX function on the weights carried over
  by ``from_flax``.
* A 2-rank training step of the tiny score model (ns=8, nv=2, one trunk
  layer, lm 0) on two different toy complexes, two poses each (B=4: rank 0
  holds one complex, rank 1 the other, so their torsion counts and padding
  differ), against the port's one-process step on the same batch and
  against JAX (``jax.value_and_grad`` of the JAX model's loss on the same
  noised batch and weights, then the JAX optimizer): loss rtol 1e-4, the
  reduced gradients rtol 2e-3 / atol 2e-4, parameters after one Adam step at
  lr 1e-3 within 2.5e-3 (tests/test_training.py:150-155), running batch
  statistics within 1e-5. Both ranks report the same metrics. At dropout
  0.1 the masks are drawn at the global batch's rows, so the step equals
  the one-process step too; the torsional step likewise.
* The 2-rank sample (plain SDE, a phase plan, SVGD) against one process
  within 1e-4 A; SVGD's within max(1e-4, 2 x the one process's own spread).
* A 4-rank (2, 2) data x model step against the one-process step.
* The environment's contracts (torchrun's and the JAX package's) start a
  2-rank world.
"""

import os
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig, TrainConfig as JaxTrainConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.parallel import mesh as jmesh
from confidence_bootstrapping_tpu.train import train_loop as jtl
from confidence_bootstrapping_tpu.train.losses import score_matching_loss as jloss
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig
from confidence_bootstrapping_tpu_torch.data import dataset
from confidence_bootstrapping_tpu_torch.data.complex_graph import batch_complexes, pad_complex, pick_bucket
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.parallel import mesh as meshlib
from confidence_bootstrapping_tpu_torch.train import diffusion
from test_datasets import _write_toy_complex_dir
from test_torch_common import install_jax_tables
from torch_parallel_worker import fields_of, run_ranks, sample_case, step2d_case, train_case

TINY = dict(ns=8, nv=2, num_conv_layers=1, num_prot_emb_layers=1, lm_embedding_dim=0)
# SVGD couples the poses and carries a rounding further than the other samplers: its samples are held to the one
# process's own spread (test_two_rank_sample_matches_one_process). The order keeps a pose of the first complex in
# row 0, whose ligand SVGD takes for every pose.
SPREAD_CASES = ("svgd",)
POSE_ORDER = torch.tensor([1, 0, 3, 2])


def toy_batch(root) -> "ComplexBatch":
    """Poses 0-1 of a 7-atom chain on 10 residues, 2-3 of a 10-atom chain on
    14 residues (4 and 7 torsions), padded to one bucket."""
    for name, seed, n_res, n_lig in (("aaaa", 0, 10, 7), ("bbbb", 1, 14, 10)):
        _write_toy_complex_dir(str(root), name, seed=seed, n_res=n_res, n_lig=n_lig)
    ds = dataset.ComplexDataset(dataset.discover_dir(str(root)), device="cpu")
    hcs = sorted(ds.complexes, key=lambda hc: hc.name)
    assert [len(hc.tor_src) for hc in hcs] == [4, 7] and [len(hc.rec_f) for hc in hcs] == [10, 14]
    bucket = pick_bucket(*(max(f(hc) for hc in hcs) for f in (lambda h: len(h.lig_f), lambda h: len(h.lig_edge_src),
                                                               lambda h: len(h.tor_src), lambda h: len(h.rec_f))))
    p = [pad_complex(hc, bucket, lm_dim=0) for hc in hcs]
    return batch_complexes([p[0], p[0], p[1], p[1]], device="cpu")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the one-process results and each rank's of a 2-rank run."""
    root = tmp_path_factory.mktemp("dp")
    with pytest.MonkeyPatch.context() as mp:
        install_jax_tables(mp)
        batch = toy_batch(root / "data")
        model = TensorProductScoreModel(ScoreModelConfig(**TINY), device="cpu", seed=0)
        inputs = dict(cfg=TINY, state=model.state_dict(), batch=fields_of(batch))
        ranks = run_ranks("dp", root / "run", 2, inputs)
        one = dict(train=train_case(inputs, None), sample=sample_case(inputs, None),
                   sample_permuted=sample_case(inputs, None, names=SPREAD_CASES, perm=POSE_ORDER),
                   sample_ranks=sample_case(inputs, None, names=SPREAD_CASES, parts=2))
        # the noised batch and targets the step's first draws give
        noised, targets = diffusion.apply_noise(batch, ScoreModelConfig(**TINY).sigma, TrainConfig(lr=1e-3),
                                                torch.Generator().manual_seed(7))
    return dict(root=root, model=model, batch=batch, inputs=inputs, ranks=ranks, one=one, noised=noised,
                targets=targets)


def test_mesh_api_in_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert meshlib.maybe_init_distributed(device="cpu") is False
    assert meshlib.coordinator_barrier("nothing") is False
    m = meshlib.make_mesh(device="cpu")
    assert m.size == 1 and m.shape == {"data": 1} and m.index("data") == 0 and m.groups == {"data": None}
    assert m.device == torch.device("cpu") and meshlib.data_mesh(m, 4) is None
    assert meshlib.batch_sharding(m).spec == ("data",) and meshlib.replicated(m).spec == ()
    x = {"a": torch.arange(6.0).reshape(3, 2), "b": (torch.ones(3), None)}
    assert torch.equal(meshlib.shard_batch(m, x)["a"], x["a"]) and meshlib.gather_batch(m, x) is x
    assert torch.equal(meshlib.replicate(m, x)["b"][0], x["b"][0])
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        meshlib.make_mesh_2d(1, 2, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        meshlib.make_mesh(4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):  # the default device is the card
            meshlib.make_mesh()


def test_mesh_api_over_two_ranks(case):
    """Each rank's slice, the gather back, rank 0's values replicated."""
    full = case["batch"].lig_pos
    for r, out in enumerate(case["ranks"]):
        api = out["api"]
        assert api["shape"] == {"data": 2} and api["index"] == r
        assert torch.equal(api["slice"], full[2 * r:2 * r + 2]) and torch.equal(api["gathered"], full)
        assert torch.equal(api["replicated"], torch.zeros(3)) and api["module_equal"]
        assert api["uneven_refused"]


def test_model_parallel_specs_cut_the_jax_leaves(case):
    """The same Flax-named leaves are cut as by the JAX function on the
    weights ``from_flax`` carries over, in the Flax layout."""
    model = case["model"]
    mesh = meshlib.Mesh(np.arange(2).reshape(1, 2), ("data", "model"), torch.device("cpu"), 0,
                        {"data": None, "model": None}, None)
    specs = meshlib.model_parallel_specs(model, mesh)
    jspecs = jmesh.model_parallel_specs(from_flax.flax_from_state_dict(model)["params"], jmesh.make_mesh_2d(1, 2))
    want = {path for path, s in jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0] if s != jax.sharding.PartitionSpec()}
    want = {tuple(k.key for k in path) for path in want}
    got = set()
    for name, spec in specs.items():
        path, transposed = from_flax.flax_path(model, name)
        if spec:
            got.add(path)
            assert spec[0 if transposed else -1] == "model" and spec.count("model") == 1
    assert got == want and len(got) > 0


def _jax_reference(case):
    """JAX's loss, gradients (by port name), new batch statistics and
    parameters after the JAX optimizer's step, on the port's noised batch."""
    jcfg = JaxScoreConfig(**TINY, dropout=0.0)
    fields = set(jcg.ComplexBatch.__dataclass_fields__)
    nb = {k: v.numpy() for k, v in fields_of(case["noised"]).items() if k in fields}
    noised = jcg.ComplexBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in nb.items()})
    targets = type(case["targets"])(*(jnp.asarray(t.numpy()) for t in case["targets"]))
    variables = from_flax.flax_from_state_dict(case["model"])
    jmodel, tc = JaxModel(jcfg), JaxTrainConfig(lr=1e-3)

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, noised,
                                deterministic=False, use_running_average=False, mutable=["batch_stats"])
        lb = jloss(out.tr_pred, out.rot_pred, out.tor_pred, targets, noised, jcfg.sigma, tc.tr_weight, tc.rot_weight,
                   tc.tor_weight)
        return lb.loss, mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tx = jtl.make_optimizer(tc)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    sd = lambda tree, c: from_flax.state_dict_from_flax({c: jax.tree.map(np.asarray, tree)})
    return dict(loss=float(loss), grads=sd(grads, "params"), stats=sd(stats, "batch_stats"),
                params=sd(params, "params"))


def _close(a: dict, b: dict, **tol):
    assert set(a) == set(b)
    for n in a:
        np.testing.assert_allclose(np.asarray(a[n]), np.asarray(b[n]), err_msg=n, **tol)


def test_two_rank_step_matches_one_process_and_jax(case):
    one = case["one"]["train"]["score0.0"]
    jax_ref = _jax_reference(case)
    np.testing.assert_allclose(one["metrics"]["loss"], jax_ref["loss"], rtol=1e-4)
    for out in case["ranks"]:
        dp = out["train"]["score0.0"]
        assert dp["metrics"]["skipped"] == 0.0
        for ref in (one, dict(metrics=dict(loss=jax_ref["loss"]), **jax_ref)):
            np.testing.assert_allclose(dp["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-4)
            _close(dp["grads"], ref["grads"], rtol=2e-3, atol=2e-4)
            _close(dp["params"], ref["params"], rtol=0, atol=2.5e-3)
        _close(dp["buffers"], one["buffers"], rtol=1e-5, atol=1e-5)
        _close(dp["buffers"], jax_ref["stats"], rtol=1e-4, atol=1e-4)
        for k in ("tr_loss", "rot_loss", "tor_loss", "tor_base_loss"):
            np.testing.assert_allclose(dp["metrics"][k], one["metrics"][k], rtol=1e-4, err_msg=k)


def test_two_ranks_agree(case):
    """Both ranks report the same metrics, and hold the same parameters,
    statistics and gradients after the step (tests/test_distributed.py's
    check)."""
    a, b = (out["train"] for out in case["ranks"])
    for key in a:
        assert a[key]["metrics"] == b[key]["metrics"], key
        for part in ("params", "buffers", "grads"):
            assert all(torch.equal(a[key][part][n], b[key][part][n]) for n in a[key][part]), (key, part)


def test_dropout_and_torsional_steps_match_one_process(case):
    """Dropout 0.1 (masks at the global rows) and the torsional step."""
    for key in ("score0.1", "torsional"):
        one = case["one"]["train"][key]
        for out in case["ranks"]:
            dp = out["train"][key]
            assert np.isfinite(dp["metrics"]["loss"]) and dp["metrics"]["skipped"] == 0.0
            np.testing.assert_allclose(dp["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-4, err_msg=key)
            _close(dp["grads"], one["grads"], rtol=2e-3, atol=2e-4)
            _close(dp["params"], one["params"], rtol=0, atol=2.5e-3)
            _close(dp["buffers"], one["buffers"], rtol=1e-5, atol=1e-5)


def test_two_rank_sample_matches_one_process(case):
    """Poses and trajectories of a plain SDE sample, one with a phase plan
    (the compaction keeps the residues of every rank's poses) and SVGD,
    within 1e-4 A of one process. SVGD's within max(1e-4, 2 x the one
    process's own spread): the larger of its samples' distances from the
    one-process sample when the poses run in another order (each with its
    own noise; 0 on the CPU, where row order changes no arithmetic) and when
    the forwards run on the two ranks' rows apart (``rank_rows``): each
    rank's forward sees half the poses, and the CPU's matrix products round
    a row by the number of rows (one ulp of the translation head at step 2),
    which SVGD's coupling carries to every pose."""
    for name, one in case["one"]["sample"].items():
        atol = dict(pos=1e-4, traj=1e-4)
        for k in atol if name in SPREAD_CASES else ():
            spread = {v: float((case["one"][f"sample_{v}"][name][k] - one[k]).abs().max())
                      for v in ("permuted", "ranks")}
            print(f"{name} {k}: the one process's spread {spread} A")
            atol[k] = max(atol[k], 2 * max(spread.values()))
        for out in case["ranks"]:
            dp = out["sample"][name]
            assert dp["pos"].shape == one["pos"].shape == case["batch"].lig_pos.shape
            for k, tol in atol.items():
                np.testing.assert_allclose(dp[k].numpy(), one[k].numpy(), rtol=0, atol=tol,
                                           err_msg=f"{name} {k} (atol {tol:.4e})")


def test_four_rank_2d_step_matches_one_process(case, tmp_path):
    """(n_data, n_model) = (2, 2): the batch over the data axis, the cut
    leaves' slices over the model axis (tests/test_training.py:129-159)."""
    with pytest.MonkeyPatch.context() as mp:
        install_jax_tables(mp)
        inputs = dict(case["inputs"], mesh2d=(2, 2))
        ranks = run_ranks("step2d", tmp_path, 4, inputs)
        one = step2d_case(inputs, None)
    for out in ranks:
        assert out["n_cut"] > 0
        np.testing.assert_allclose(out["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-4)
        _close(out["params"], one["params"], rtol=0, atol=2.5e-3)
        _close(out["buffers"], one["buffers"], rtol=1e-5, atol=1e-5)
    assert all(torch.equal(ranks[0]["params"][n], r["params"][n]) for r in ranks[1:] for n in r["params"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("contract", ["torchrun", "jax"])
def test_environment_contract_starts_the_world(contract, tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    port = _free_port()
    if contract == "torchrun":
        env = lambda r: dict(WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port))
    else:
        env = lambda r: dict(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                             JAX_PROCESS_ID=str(r))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    outs = run_ranks("env", tmp_path, 2, {}, timeout=120, env=env)
    assert [(o["world"], o["rank"], o["backend"], o["total"]) for o in outs] == [(2, r, "gloo", 3.0) for r in (0, 1)]


def test_featurization_cache_is_written_atomically(tmp_path, monkeypatch):
    """Ranks featurize the same complexes into one cache: a reader never
    sees a cache file before it is whole (written aside, then renamed)."""
    _write_toy_complex_dir(str(tmp_path / "data"), "aaaa", seed=0, n_res=10)
    cache = tmp_path / "cache"
    seen = []
    real_dump = pickle.dump

    def dump(obj, f, *a, **k):
        seen.append(sorted(os.listdir(cache)))  # what another rank would find while this one writes
        return real_dump(obj, f, *a, **k)

    monkeypatch.setattr(pickle, "dump", dump)
    ds = dataset.ComplexDataset(dataset.discover_dir(str(tmp_path / "data")), cache_dir=str(cache), device="cpu")
    assert len(ds.complexes) == 1 and len(seen) == 1 and not any(n.endswith(".pkl") for n in seen[0])
    assert [n for n in os.listdir(cache) if not n.endswith(".pkl")] == []
    again = dataset.ComplexDataset(dataset.discover_dir(str(tmp_path / "data")), cache_dir=str(cache), device="cpu")
    assert again.complexes[0].name == "aaaa" and len(seen) == 1
