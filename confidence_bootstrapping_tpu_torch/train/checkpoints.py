"""Model directories: the config yaml and the weights as a Flax msgpack bundle.

Port of ``confidence_bootstrapping_tpu/train/checkpoints.py`` for weights
and configs: a model directory holds ``model_config.yml`` (``config.save_yaml``)
and ``<name>.msgpack``, the Flax variables ``{"params": ..., "batch_stats":
...}`` in the bytes ``flax.serialization.to_bytes`` writes. A directory the
JAX package wrote loads here without flax, msgpack or PyYAML
(``train.flax_msgpack``, ``yaml_io``), and one written here loads in the JAX
package. Loading is strict: the file must hold every parameter and buffer
of the module, nothing else, at the same shapes; a mismatch raises
``ValueError`` naming the key. Train-state bundles (``save_train_state``)
come with the training remainder.
"""

from __future__ import annotations

import os

from torch import nn

from ..config import ScoreModelConfig, load_score_config, save_yaml
from ..models.from_flax import flax_from_state_dict, state_dict_from_flax
from . import flax_msgpack

CONFIG_NAME = "model_config.yml"


def save_params(path: str, model: nn.Module) -> None:
    """Write ``model``'s weights as Flax variables in msgpack, keys sorted at
    every level as the JAX package's ``save_params`` writes them (its
    ``jax.device_get`` rebuilds every dict in sorted order): the same
    weights give the same bytes."""
    with open(path, "wb") as f:
        f.write(flax_msgpack.to_bytes(_sorted(flax_from_state_dict(model))))


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Read a Flax msgpack bundle into ``model`` (strict; see the module
    docstring). Returns ``model``."""
    with open(path, "rb") as f:
        variables = flax_msgpack.restore(f.read())
    if not isinstance(variables, dict):
        raise ValueError(f"{path}: not a bundle of Flax variables")
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra:
        raise ValueError(f"{path}: collections the model does not have: {', '.join(map(str, extra))}")
    sd = state_dict_from_flax(variables)
    own = model.state_dict()
    for key in own:
        if key not in sd:
            raise ValueError(f"{path}: no value for {key}")
        if tuple(sd[key].shape) != tuple(own[key].shape):
            raise ValueError(f"{path}: {key} has shape {tuple(sd[key].shape)}, the model {tuple(own[key].shape)}")
    for key in sd:
        if key not in own:
            raise ValueError(f"{path}: {key} is not a parameter or buffer of the model")
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model


def save_model_dir(model_dir: str, cfg: ScoreModelConfig, model: nn.Module, name: str = "last_model") -> None:
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(cfg, os.path.join(model_dir, CONFIG_NAME))
    save_params(os.path.join(model_dir, f"{name}.msgpack"), model)


def load_model_dir(model_dir: str, model: nn.Module, name: str = "last_model") -> tuple:
    """(the directory's config, ``model`` with the directory's weights)."""
    cfg = load_score_config(os.path.join(model_dir, CONFIG_NAME))
    return cfg, load_params(os.path.join(model_dir, f"{name}.msgpack"), model)


def has_checkpoint(model_dir: str, name: str = "last_model") -> bool:
    return os.path.exists(os.path.join(model_dir, f"{name}.msgpack"))
