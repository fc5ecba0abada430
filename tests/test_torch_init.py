"""The port's seeded weights are drawn as Flax's defaults draw them.

Every ``nn.Dense`` of the JAX package keeps Flax's default initialisers
(no ``kernel_init`` or ``bias_init`` anywhere in the package): LeCun-normal
kernels, ``variance_scaling(1.0, "fan_in", "truncated_normal")`` (a
standard normal truncated to [-2, 2], divided by its own standard
deviation 0.87962566103423978 and scaled by sqrt(1/fan_in)), and zero
biases. ``models/score_model.init_weights`` draws every ``nn.Linear`` of the
three model families so. Checked here on small widths of the score model,
the all-atom confidence model and the legacy model:

* every bias is exactly zero;
* every weight lies within +-2 sqrt(1/fan_in) / 0.8796;
* every weight tensor of 2048 elements or more has a standard deviation
  within 5% of sqrt(1/fan_in);
* the weights, each scaled by sqrt(fan_in), fall into ten equal bins over
  the truncation range in the shares that ``flax.linen.initializers.
  lecun_normal()`` gives the same shapes, within five standard errors of
  the difference of two shares of that many draws (sqrt(2 / 4 / n), the
  largest a share's variance can be).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from flax.linen import initializers

from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, confidence_model_config
from confidence_bootstrapping_tpu_torch.models.factory import get_model
from confidence_bootstrapping_tpu_torch.models.score_model import LECUN_TRUNC_STD

MODELS = {
    "score": lambda: ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0),
    "all_atom_confidence": lambda: confidence_model_config(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=16),
    "legacy": lambda: ScoreModelConfig(ns=8, nv=2, sh_lmax=2, num_conv_layers=2, lm_embedding_dim=16,
                                       old_score_model=True),
}
EDGE = 2.0 / LECUN_TRUNC_STD  # the truncation bound in units of sqrt(1/fan_in)


def linears(model) -> list:
    return [m for m in model.modules() if isinstance(m, torch.nn.Linear)]


def test_truncated_std_is_flax_constant():
    """The constant is the standard deviation of N(0, 1) cut to [-2, 2]."""
    from scipy import stats

    assert abs(stats.truncnorm(-2, 2).std() - LECUN_TRUNC_STD) < 1e-15


@pytest.mark.parametrize("family", list(MODELS))
def test_linear_layers_follow_flax_dense_defaults(family):
    model = get_model(MODELS[family](), device="cpu", seed=3)
    lins = linears(model)
    assert len(lins) > 5
    scaled, big = [], 0
    for i, lin in enumerate(lins):
        w = lin.weight.detach().double()
        fan_in = lin.in_features
        if lin.bias is not None:
            assert torch.count_nonzero(lin.bias) == 0, i
        assert w.abs().max() <= EDGE * fan_in ** -0.5 * (1 + 1e-6), i
        if w.numel() >= 2048:
            big += 1
            assert abs(w.std().item() / fan_in ** -0.5 - 1) < 0.05, (i, tuple(w.shape))
        scaled.append((w * fan_in ** 0.5).flatten().numpy())
    assert big > 0
    got = np.concatenate(scaled)
    # flax's initialiser on the same shapes (a Dense kernel is [in, out])
    keys = jax.random.split(jax.random.PRNGKey(0), len(lins))
    want = np.concatenate([np.asarray(initializers.lecun_normal()(k, (lin.in_features, lin.out_features)),
                                      np.float64).ravel() * lin.in_features ** 0.5 for k, lin in zip(keys, lins)])
    assert got.size == want.size
    bins = np.linspace(-EDGE, EDGE, 11)
    assert want.min() >= bins[0] - 1e-5 and want.max() <= bins[-1] + 1e-5
    share = lambda x: np.histogram(np.clip(x, bins[0], bins[-1]), bins)[0] / x.size
    tol = 5 * np.sqrt(2 * 0.25 / got.size)
    diff = np.abs(share(got) - share(want))
    assert diff.max() < tol, (family, got.size, diff.round(4), tol)
