"""The port's score model against the JAX package's, weights carried over by
the bridge (models/from_flax.py).

A tiny config (ns=16, nv=4, 1 embedding layer, 2 trunk layers) on the padded
1a0q complex, poses jittered around the crystal ligand, random batch-norm
statistics. On the CPU the JAX model takes its XLA path (the Pallas kernels
need a TPU) and the port takes its kernels' plain versions, both in float32.
Tolerance: |port - jax| <= 2e-4 * max(1, max |jax|) per output, a few float32
ulps of the sums after five message-passing layers in another order.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from test_torch_common import both_batches, install_jax_score_norms, padded_1a0q, perturbed_pose, randomize_stats, tiny_configs

B = 2
REL = 2e-4


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * scale)


def _models(lm_dim, jb):
    jcfg, tcfg = tiny_configs(lm_dim)
    jmodel = JaxModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    model = TensorProductScoreModel(tcfg, device="cpu")
    from_flax.load_flax_variables(model, variables)
    return jmodel, variables, model


@pytest.mark.parametrize("lm_dim", [0, 8])
def test_forward_matches_jax(lm_dim, monkeypatch):
    install_jax_score_norms(monkeypatch)
    padded = padded_1a0q(lm_dim)
    jb, tb = both_batches(padded, B, lig_pos=perturbed_pose(padded, B), t=0.6)
    jmodel, variables, model = _models(lm_dim, jb)
    want = jax.jit(jmodel.apply)(variables, jb)
    got = model(tb)
    for name in ("tr_pred", "rot_pred", "tor_pred"):
        _close(getattr(got, name), getattr(want, name))
    assert float(np.abs(np.asarray(want.tor_pred)).max()) > 0  # the torsion head ran


def test_embed_receptor_matches_jax():
    padded = padded_1a0q(8)
    jb, tb = both_batches(padded, 1)
    jmodel, variables, model = _models(8, jb)
    want = jax.jit(functools.partial(jmodel.apply, method="embed_receptor"))(variables, jb)
    got = model.embed_receptor(tb)
    _close(got.rec_attr, want.rec_attr)
    _close(got.rec_edge_emb, want.rec_edge_emb)
    np.testing.assert_array_equal(got.rec_edge_mask.numpy(), np.asarray(want.rec_edge_mask))


def test_bridge_maps_every_variable():
    """Every Flax leaf lands on a port tensor of the same size (kernels
    transposed), and the port has no tensor the bridge leaves unset."""
    jcfg, tcfg = tiny_configs(8)
    padded = padded_1a0q(8)
    jb, _ = both_batches(padded, 1)
    variables = jax.tree.map(np.asarray, jax.jit(JaxModel(jcfg).init)(jax.random.PRNGKey(1), jb))
    sd = from_flax.state_dict_from_flax(variables)
    model = TensorProductScoreModel(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    n_leaves = len(jax.tree.leaves(variables))
    assert len(sd) == n_leaves
    w = variables["params"]["conv_layers_0"]["edge_mlps_2"]["Dense_1"]["kernel"]
    np.testing.assert_array_equal(sd["conv_layers.0.edge_mlps.2.layers.1.weight"].numpy(), w.T)
    np.testing.assert_array_equal(sd["rec_emb_layers.0.bn.norm"].numpy(),
                                  variables["batch_stats"]["rec_emb_layers_0"]["bn"]["norm"])


def test_model_weights_are_seeded():
    _, tcfg = tiny_configs(0)
    a = TensorProductScoreModel(tcfg, device="cpu", seed=3).state_dict()
    b = TensorProductScoreModel(tcfg, device="cpu", seed=3).state_dict()
    c = TensorProductScoreModel(tcfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_layers.0.edge_mlps.0.layers.1.weight"], c["conv_layers.0.edge_mlps.0.layers.1.weight"])
