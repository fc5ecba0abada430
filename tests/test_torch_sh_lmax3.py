"""The port at ``sh_lmax = 3`` against the JAX package.

* The l = 3 harmonics (``spherical_harmonics``, the kernels' ``sh_kernel``)
  and the Clebsch-Gordan tensors of every (l1, l2, l3) with l <= 3, and the
  route a layer takes: "edge", the edge-list kernel alone, never the
  kernels that gather their senders (rec_g, cross_g, the rec training op),
  which the JAX package runs at ``sh_lmax <= 2`` only.
* The plain versions the CUDA wrappers run for CPU tensors at 16-wide
  harmonics: the edge-list sums and per-edge messages (row 7) against the
  Pallas kernels ``fused_tpconv_nbr_g``/``msgs_g``, and the training op's
  forward and gradients (rows 10-11: the edge backward's plain version)
  against the Pallas ``fused_tpconv_train`` custom_vjp (``edge_bwd_pallas``
  in its backward), each run as tests/test_pallas_tpconv.py runs them
  (interpret=True, use_bf16=False), within 2e-4 x max(1, max |pallas|)
  (gradients rtol 2e-3).
* The models every ``sh_lmax = 3`` configuration the JAX package builds
  names, on the small all-atom 1a0q complex (64 residues, 512 atoms), B=2
  poses at ns=8, nv=2, two trunk layers, dropout 0, the port's seeded weights
  and random batch-norm statistics carried to the JAX model
  (``from_flax.flax_from_state_dict``): the forwards of the score model with
  ``no_torsion`` (D), the all-atom confidence model (E), the second-order
  ladder with ``no_torsion`` (F), the residue-level confidence model and the
  legacy one against ``model.apply`` within 2e-4 x max(1, max |jax|); (D)'s training
  loss within 1e-4 and every gradient within rtol 2e-3 of
  ``jax.value_and_grad``, and its model directory read by the other package
  bit for bit, both ways, and its reference state dict converted by both
  packages' converters to the same tree. Each JAX model is jitted once: (D)
  forward and gradients in one function.
* The factory's refusals: a torsion head at ``sh_lmax = 3`` (the JAX
  package's ``KeyError: 5``) and ``sh_lmax = 4``.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 17).
"""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models import convert as jconvert, factory as jfactory
from confidence_bootstrapping_tpu.ops import irreps as jirreps
from confidence_bootstrapping_tpu.ops.pallas import tpconv_g as jtpg, tpconv_train as jtpt
from confidence_bootstrapping_tpu.train import checkpoints as jcheckpoints
from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, confidence_model_config
from confidence_bootstrapping_tpu_torch.models import convert, factory, from_flax
from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel
from confidence_bootstrapping_tpu_torch.models.legacy import OldTensorProductScoreModel
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.ops import irreps
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common, tpconv_edge, tpconv_train
from confidence_bootstrapping_tpu_torch.train import checkpoints, train_loop
from test_torch_common import install_jax_score_norms, perturbed_pose, port_batch, randomize_stats
from test_torch_confidence import LM, small_complex

SH3 = tpconv_common.SH3_IRREPS
REL = 2e-4
BASE = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=0, lm_embedding_dim=LM, dropout=0.0, sh_lmax=3)
SCORE = dict(no_torsion=True)  # (D)
FORWARDS = {
    "all_atom_confidence": dict(all_atoms=True, confidence_mode=True),  # (E)
    "second_order": dict(use_second_order_repr=True, no_torsion=True),  # (F)
    "residue_confidence": dict(confidence_mode=True),
    "legacy_confidence": dict(old_score_model=True, confidence_mode=True),
}


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())), err_msg=what)


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else np.array(a))


# ----------------------------------------------------------------------------- harmonics, CG and routes


def test_harmonics_and_clebsch_gordan_match_jax_up_to_l3():
    rng = np.random.RandomState(0)
    v = rng.randn(64, 3).astype(np.float32)
    v[0] = 0.0  # a zero vector: the kernels' clamp gives zero in every l >= 1 component
    want = np.asarray(jirreps.spherical_harmonics(3, jnp.asarray(v[1:])))
    _close(irreps.spherical_harmonics(3, torch.as_tensor(v[1:])), want, rel=1e-6)
    got = tpconv_common.sh_kernel(torch.as_tensor(v), SH3)
    _close(got[1:], want, rel=1e-6)
    assert got.shape == (64, 16) and got[0, 0] == 1.0 and not got[0, 1:].any()
    # the l = 3 block is itself normalized: E |Y_3|^2 = 7 on the sphere
    u = rng.randn(20000, 3)
    np.testing.assert_allclose((irreps.spherical_harmonics(3, torch.as_tensor(u))[:, 9:] ** 2).sum(-1).mean(), 7.0,
                               rtol=0.05)
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1):
                np.testing.assert_allclose(irreps.clebsch_gordan(l1, l2, l3), jirreps.clebsch_gordan(l1, l2, l3),
                                           rtol=0, atol=1e-9, err_msg=f"{l1} x {l2} -> {l3}")
    with pytest.raises(NotImplementedError, match="l=3"):
        irreps.spherical_harmonics(4, torch.as_tensor(v))


def test_layers_take_the_edge_list_kernel_and_no_gather_kernel():
    """Every conv layer of (D) on the "edge" route with 16-wide harmonics:
    none takes rec_g, cross_g or the rec training op, as the JAX package's
    ``sh_lmax <= 2`` gate; lmax 1 and 2 keep the general route."""
    assert tpconv_common.sh_dim(SH3) == 16 and tpconv_common.takes_harmonics(SH3)
    assert not tpconv_common.gather_harmonics(SH3)
    assert tpconv_common.gather_harmonics(tpconv_common.SH_IRREPS)
    assert tpconv_common.gather_harmonics(tpconv_common.SH2_IRREPS)
    model = factory.get_model(ScoreModelConfig(**dict(BASE, **SCORE)), device="cpu")
    convs = list(model.rec_emb_layers if hasattr(model, "rec_emb_layers") else []) + list(model.conv_layers)
    assert convs and all(c.route == "edge" for c in convs)
    assert model.final_conv.route == "edge" and model.final_conv.sh_irreps == str(irreps.Irreps(SH3))
    for lmax in (1, 2):
        m = factory.get_model(ScoreModelConfig(**dict(BASE, **SCORE, sh_lmax=lmax)), device="cpu")
        assert all(c.route in ("ladder", "general") for c in m.conv_layers)


def test_rec_and_cross_gather_the_senders_at_sh_lmax3(monkeypatch):
    """``conv_rec`` and ``conv_cross`` at inference and in training call the
    edge-list op (``fused_tpconv_edge`` / ``fused_tpconv_train``) with
    16-wide harmonics and never rec_g, cross_g or the rec training op."""
    from confidence_bootstrapping_tpu_torch.models import layers

    calls = []
    for name in ("fused_tpconv_rec_g", "fused_tpconv_cross_g", "fused_tpconv_rec_train", "fused_tpconv_rec",
                 "fused_tpconv_cross"):
        monkeypatch.setattr(layers, name, lambda *a, _n=name, **k: calls.append(_n))
    for name in ("fused_tpconv_edge", "fused_tpconv_train"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **k: (calls.append((_n, a[2].shape[-1])),
                                                                             _f(*a, **k))[1])
    rng = np.random.RandomState(3)
    conv = layers.TPConv("4x0e + 1x1o", SH3, "4x0e + 1x1o + 1x1e", 12)
    B, N, K, L = 1, 6, 3, 4
    node, pos = torch.as_tensor(rng.randn(B, N, 7), dtype=torch.float32), torch.as_tensor(rng.randn(B, N, 3))
    nbr, mask = torch.as_tensor(rng.randint(0, N, (B, N, K))), torch.ones(B, N, K, dtype=torch.bool)
    emb, sig = torch.as_tensor(rng.randn(B, N, K, 4), dtype=torch.float32), torch.zeros(B, 4)
    for det in (True, False):
        conv.conv_rec(0, node, pos.float(), nbr, emb, sig, mask, deterministic=det)
        conv.conv_cross(0, node[:, :L], pos[:, :L].float(), node, pos.float(), nbr[:, :L], emb[:, :L],
                        mask[:, :L], 4, deterministic=det)
    assert calls == [("fused_tpconv_edge", 16)] * 2 + [("fused_tpconv_train", 16)] * 2


# ----------------------------------------------------------------------------- plain kernels against Pallas

LAYER = ("4x0e + 1x1o + 1x1e", "4x0e + 1x1o + 1x1e + 1x0o")  # the lmax=1 ladder's 2 -> 3 layer, 16-wide harmonics


def _edge_case(M, K, H, seed):
    rng = np.random.RandomState(seed)
    irreps_in, irreps_out = LAYER
    tp = irreps.WeightedTensorProduct(irreps_in, SH3, irreps_out)
    F = 12
    attr = rng.randn(M, K, F).astype(np.float32)
    sender = rng.randn(M, K, tp.irreps_in.dim).astype(np.float32)
    sh = np.asarray(jirreps.spherical_harmonics(3, jnp.asarray(rng.randn(M, K, 3).astype(np.float32))))
    mask = rng.rand(M, K) > 0.3
    mask[2] = False  # a row with no edge: zero sum
    w = [rng.randn(F, H).astype(np.float32) * 0.2, rng.randn(H).astype(np.float32) * 0.1,
         rng.randn(H, tp.weight_numel).astype(np.float32) * 0.2, rng.randn(tp.weight_numel).astype(np.float32) * 0.1]
    return (attr, sender, sh, mask, *w)


def test_edge_list_plain_matches_pallas_at_16_wide_harmonics():
    """Row 7: sums and per-edge messages, masked edges exactly zero."""
    args = _edge_case(16, 5, 18, seed=1)
    ir = (LAYER[0], SH3, LAYER[1])
    assert tpconv_common.general_route(*ir)
    got_sum = tpconv_edge.fused_tpconv_edge(*map(_torch, args), *ir, sum_k=True)
    got_msg = tpconv_edge.fused_tpconv_edge(*map(_torch, args), *ir, sum_k=False)
    _close(got_sum, jtpg.fused_tpconv_nbr_g(*args, *ir, interpret=True, use_bf16=False))
    _close(got_msg, jtpg.fused_tpconv_msgs_g(*args, *ir, interpret=True, use_bf16=False))
    assert not got_msg.numpy()[~args[3]].any() and not got_sum[2].any()


@pytest.mark.parametrize("dropout", [False, True])
def test_training_op_gradients_match_pallas_at_16_wide_harmonics(dropout):
    """Rows 10-11: the op's K-sum forward and the gradients of its MLP input,
    senders, harmonics and weights (the edge backward's plain version; the
    JAX package's ``edge_bwd_pallas``), with and without the dropout mask."""
    ir = (LAYER[0], SH3, LAYER[1])
    args = _edge_case(12, 4, 18, seed=5)
    rng = np.random.RandomState(6)
    dm = ((rng.rand(12, 4, 18) < 0.9) / 0.9).astype(np.float32) if dropout else None
    g = rng.randn(12, irreps.Irreps(LAYER[1]).dim).astype(np.float32)
    diff = (0, 1, 2, 4, 5, 6, 7)  # attr, sender, sh and the MLP's weights

    def jfn(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return jtpt.fused_tpconv_train(*full, *ir, dmask=None if dm is None else jnp.asarray(dm), use_bf16=False,
                                       interpret=True)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(args[i]) for i in diff))
    want_g = vjp(jnp.asarray(g))
    leaves = [_torch(a).requires_grad_(i in diff) if a.dtype == np.float32 else _torch(a) for i, a in enumerate(args)]
    got = tpconv_train.fused_tpconv_train(*leaves, *ir, dmask=None if dm is None else _torch(dm))
    got_g = torch.autograd.grad(got, [leaves[i] for i in diff], _torch(g))
    _close(got, want)
    for i, a, b in zip(diff, got_g, want_g):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(b).max())), err_msg=i)


# ----------------------------------------------------------------------------- the models


@pytest.fixture(scope="module")
def batches():
    padded, _ = small_complex()
    jb = jcg.replicate_complex(padded, 2).replace(lig_pos=jnp.asarray(perturbed_pose(padded, 2, seed=3)))
    jb = jb.set_time(0.6, 0.5, 0.4)
    return jb, port_batch(jb)


@pytest.fixture(scope="module")
def norms():
    install = pytest.MonkeyPatch()
    install_jax_score_norms(install)
    yield
    install.undo()


def _models(kw, seed):
    cfg = dict(BASE, **kw)
    model = factory.get_model(ScoreModelConfig(**cfg), device="cpu", seed=seed)
    variables = randomize_stats(from_flax.flax_from_state_dict(model), seed=seed)
    from_flax.load_flax_variables(model, variables)
    return model, variables, jfactory.get_model(JaxScoreConfig(**cfg))


def _loss(out, mod):
    return sum(mod.sum(getattr(out, f) ** 2) for f in ("tr_pred", "rot_pred"))


@pytest.fixture(scope="module")
def score(batches, norms):
    """(D): the port's model and the JAX forward, loss, gradients and batch
    statistics of the training forward, in one jitted function."""
    jb, tb = batches
    model, variables, jmodel = _models(SCORE, seed=0)

    def run(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb)

        def loss_fn(p):
            o, mut = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb, deterministic=False,
                                  use_running_average=False, mutable=["batch_stats"])
            return _loss(o, jnp), mut["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, loss, grads, stats

    return model, jax.jit(run)(variables["params"]), tb


def test_score_model_forward_matches_jax(score):
    model, (want, _, _, _), tb = score
    assert isinstance(model, TensorProductScoreModel) and model.cfg.no_torsion
    got = model(tb)
    for f in ("tr_pred", "rot_pred"):
        _close(getattr(got, f), getattr(want, f), what=f)
    assert float(np.abs(np.asarray(want.tr_pred)).max()) > 0 and not got.tor_pred.any()


def test_score_model_training_loss_and_gradients_match_jax(score):
    model, (_, loss, grads, stats), tb = score
    grads = from_flax.state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)})
    stats = from_flax.state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, stats)})
    model.requires_grad_(True)
    saved = train_loop.batch_stats(model)
    try:
        got = _loss(model(tb, deterministic=False, use_running_average=False), torch)
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
        named = list(model.named_parameters())
        assert {n for n, _ in named} == set(grads)
        g = torch.autograd.grad(got, [p for _, p in named], allow_unused=True)
        nonzero = 0
        for (n, p), gn in zip(named, g):
            want = grads[n].numpy()
            gn = np.zeros_like(want) if gn is None else gn.numpy()
            np.testing.assert_allclose(gn, want, rtol=2e-3, atol=2e-4 * max(1.0, float(np.abs(want).max(initial=0))),
                                       err_msg=n)
            nonzero += bool(np.any(want != 0))
        assert nonzero > 0.7 * len(named)
        for n, v in stats.items():
            np.testing.assert_allclose(model.get_buffer(n).numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=n)
    finally:
        train_loop.keep_batch_stats(model, saved, torch.tensor(False))
        model.requires_grad_(False)


def test_score_model_dirs_round_trip_both_ways(score, tmp_path, capsys):
    """The port's directory read by the JAX package's ``load_model_dir`` bit
    for bit, and the JAX package's (the weights shifted) by the port's
    loader bit for bit."""
    model, (_, _, grads, stats), _ = score
    checkpoints.save_model_dir(str(tmp_path / "port"), model.cfg, model)
    template = {"params": jax.tree.map(np.asarray, grads), "batch_stats": jax.tree.map(np.asarray, stats)}
    jcfg, got = jcheckpoints.load_model_dir(str(tmp_path / "port"), template)
    assert jcfg == JaxScoreConfig(**dict(BASE, **SCORE)) and jcfg.sh_lmax == 3
    got = jax.tree.map(np.asarray, got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(from_flax.flax_from_state_dict(model))):
        np.testing.assert_array_equal(a, b)
    shifted = jax.tree.map(lambda a: a + 0.25, got)
    jcheckpoints.save_model_dir(str(tmp_path / "jax"), jcfg, shifted)
    back, cfg = load_or_init_model(str(tmp_path / "jax"), "last_model", device="cpu")
    assert "loaded weights" in capsys.readouterr().out and cfg == model.cfg
    for a, b in zip(jax.tree.leaves(from_flax.flax_from_state_dict(back)), jax.tree.leaves(shifted)):
        np.testing.assert_array_equal(a, b)


def test_score_model_reference_checkpoint_converts_as_in_jax(score):
    """(D) as a reference ``.pt`` state dict (e3nn's layout, every TP on the
    generic product at 16-wide harmonics): both packages' converters give the
    same Flax tree bit for bit, the model's own variables."""
    model = score[0]
    sd = chip_smoke.reference_state_dict(model)
    got = convert.convert_state_dict(sd, model.cfg)
    want = jconvert.convert_state_dict(sd, JaxScoreConfig(**dict(BASE, **SCORE)))
    mine = from_flax.flax_from_state_dict(model)
    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want), jax.tree.leaves(mine)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes() == np.asarray(c).tobytes()
    assert jax.tree.structure(got) == jax.tree.structure(want) == jax.tree.structure(mine)


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_matches_jax(name, batches, norms):
    """(E), (F), the residue-level confidence model and the legacy one: the
    inference forward against ``model.apply``."""
    jb, tb = batches
    model, variables, jmodel = _models(FORWARDS[name], seed=sorted(FORWARDS).index(name) + 1)
    want, got = jax.jit(jmodel.apply)(variables, jb), model(tb)
    fields = ("confidence",) if model.cfg.confidence_mode else ("tr_pred", "rot_pred")
    for f in fields:
        _close(getattr(got, f), getattr(want, f), what=f"{name} {f}")
        assert float(np.abs(np.asarray(getattr(want, f))).max()) > 0
    assert isinstance(model, OldTensorProductScoreModel if model.cfg.old_score_model
                      else AllAtomScoreModel if model.cfg.all_atoms else TensorProductScoreModel)


# ----------------------------------------------------------------------------- the factory's refusals


@pytest.mark.parametrize("kw", [dict(), dict(all_atoms=True), dict(old_score_model=True),
                                dict(use_second_order_repr=True)])
def test_torsion_head_at_sh_lmax3_is_refused_as_in_jax(kw):
    """Score mode with the torsion head at sh_lmax = 3: the JAX package's
    ``final_tp_tor`` reaches l = 5 and raises ``KeyError: 5``; the port's
    factory (and the models themselves) refuse it by name, and build it
    with ``no_torsion`` or ``confidence_mode``."""
    with pytest.raises(KeyError, match="5"):  # the CG tensor of final_tp_tor's 3e x 2e -> 5o path
        jirreps.clebsch_gordan(3, 2, 5)
    cfg = ScoreModelConfig(**dict(BASE, **kw))
    assert factory.unsupported_fields(cfg) and "KeyError: 5" in factory.unsupported_fields(cfg)[0]
    with pytest.raises(ValueError, match=r"sh_lmax=3.*KeyError: 5"):
        factory.get_model(cfg, device="cpu")
    cls = {"all_atoms": AllAtomScoreModel, "old_score_model": OldTensorProductScoreModel}
    model_cls = next((cls[k] for k in kw if k in cls), TensorProductScoreModel)
    with pytest.raises(ValueError, match="KeyError: 5"):
        model_cls(cfg, device="cpu")
    for ok in (dataclasses.replace(cfg, no_torsion=True), dataclasses.replace(cfg, confidence_mode=True)):
        assert not factory.unsupported_fields(ok)


def test_sh_lmax4_is_refused():
    for cfg in (ScoreModelConfig(**dict(BASE, sh_lmax=4, no_torsion=True)),
                confidence_model_config(ns=8, nv=2, sh_lmax=4)):
        with pytest.raises(ValueError, match="sh_lmax=4.*l >= 4"):
            factory.get_model(cfg, device="cpu")
