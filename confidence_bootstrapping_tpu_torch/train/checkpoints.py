"""Model directories: the config yaml and the weights as a Flax msgpack bundle.

Port of ``confidence_bootstrapping_tpu/train/checkpoints.py`` for weights
and configs: a model directory holds ``model_config.yml`` (``config.save_yaml``)
and ``<name>.msgpack``, the Flax variables ``{"params": ..., "batch_stats":
...}`` in the bytes ``flax.serialization.to_bytes`` writes. A directory the
JAX package wrote loads here without flax, msgpack or PyYAML
(``train.flax_msgpack``, ``yaml_io``), and one written here loads in the JAX
package. Loading is strict: the file must hold every parameter and buffer
of the module, nothing else, at the same shapes; a mismatch raises
``ValueError`` naming the key.

A train-state bundle (``save_train_state``) is the JAX package's
``{"state": TrainState, "epoch"}`` in the same msgpack form: parameters,
batch statistics, optax's state of ``chain(clip_by_global_norm, adam)``
(``ScaleByAdamState`` count/mu/nu, nested as the chain nests it), the EMA
parameters, ``step`` and ``lr_scale``. Adam's moments map to and from
``torch.optim.Adam``/``AdamW``'s ``exp_avg``/``exp_avg_sq`` and its count to
their ``step``; a bundle either package wrote loads in the other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import ScoreModelConfig, load_score_config, save_yaml
from ..models.from_flax import flax_from_state_dict, flax_tree, state_dict_from_flax
from . import flax_msgpack

CONFIG_NAME = "model_config.yml"


def save_params(path: str, model: nn.Module, params: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write ``model``'s weights as Flax variables in msgpack, keys sorted at
    every level as the JAX package's ``save_params`` writes them (its
    ``jax.device_get`` rebuilds every dict in sorted order): the same
    weights give the same bytes. ``params`` ({name: tensor} over every
    parameter, e.g. the EMA copy) is written in place of the module's
    parameters, beside its buffers."""
    with open(path, "wb") as f:
        f.write(flax_msgpack.to_bytes(_sorted(flax_from_state_dict(model, params))))


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
    sd = _matching(path, state_dict_from_flax(variables), model.state_dict(), "parameter or buffer of the model")
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model


def _matching(path: str, got: dict, own: dict, what: str) -> dict:
    """``got`` if it has exactly ``own``'s keys at ``own``'s shapes, else
    ``ValueError`` naming the first key that differs."""
    for key in own:
        if key not in got:
            raise ValueError(f"{path}: no value for {key}")
        if tuple(got[key].shape) != tuple(own[key].shape):
            raise ValueError(f"{path}: {key} has shape {tuple(got[key].shape)}, the model {tuple(own[key].shape)}")
    for key in got:
        if key not in own:
            raise ValueError(f"{path}: {key} is not a {what}")
    return got


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


# --- full train-state bundles (reference train.py:145-150 saves
# {epoch, model, optimizer, ema_weights}; --restart_dir restores all of it,
# train.py:194-207) ---

STATE_NAME = "last_state"


def _adam_moments(state) -> tuple:
    """(count, {name: exp_avg}, {name: exp_avg_sq}) of the state's Adam or
    AdamW; zeros before its first step."""
    count, mu, nu = 0, {}, {}
    for n, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
        mu[n] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[n] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    return count, mu, nu


def _opt_tree(state) -> dict:
    """optax's state of ``make_optimizer``'s chain as flax writes it: a
    tuple is a dict keyed "0", "1", ...; adam is (ScaleByAdamState,
    EmptyState), adamw has one more EmptyState (its weight decay), and a
    clip wraps it as (EmptyState, that tuple)."""
    count, mu, nu = _adam_moments(state)
    adam = {"count": np.asarray(count, np.int32), "mu": flax_tree(state.model, mu), "nu": flax_tree(state.model, nu)}
    tx = {"0": adam, "1": {}}
    if isinstance(state.optimizer, torch.optim.AdamW):
        tx["2"] = {}
    return {"0": {}, "1": tx} if state.grad_clip else tx


def _sorted_tree(tree):
    return {k: _sorted_tree(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def save_train_state(model_dir: str, state, epoch: int, name: str = STATE_NAME) -> None:
    """Write ``<model_dir>/<name>.msgpack``: ``{"state": TrainState, "epoch"}``
    as the JAX package's ``save_train_state`` writes it (the state's fields
    in TrainState's order, every dict inside sorted, as ``jax.device_get``
    leaves them)."""
    os.makedirs(model_dir, exist_ok=True)
    variables = flax_from_state_dict(state.model)
    tree = {
        "params": _sorted_tree(variables.get("params", {})),
        "batch_stats": _sorted_tree(variables.get("batch_stats", {})),
        "opt_state": _sorted_tree(_opt_tree(state)),
        "ema_params": _sorted_tree(flax_tree(state.model, state.ema)),
        "step": np.asarray(state.step, np.int32),
        "lr_scale": np.asarray(state.lr_scale, np.float32),
    }
    with open(os.path.join(model_dir, f"{name}.msgpack"), "wb") as f:
        f.write(flax_msgpack.to_bytes({"state": tree, "epoch": np.int64(epoch)}))


def _find_adam(tree):
    """The ``ScaleByAdamState`` dict (count, mu, nu) inside an optax chain's state."""
    if isinstance(tree, dict):
        if set(tree) == {"count", "mu", "nu"}:
            return tree
        for v in tree.values():
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def load_train_state(model_dir: str, template_state, name: str = STATE_NAME):
    """Returns (state, epoch): ``template_state`` (a freshly initialized
    TrainState of the same model) with the bundle's parameters, batch
    statistics, EMA, Adam state, step and lr_scale, on the template's
    device; or (None, 0), the template untouched, when the bundle is absent
    or corrupt (the reference falls back to best_model on a corrupt bundle;
    we fall back to weights-only restore)."""
    path = os.path.join(model_dir, f"{name}.msgpack")
    if not os.path.exists(path):
        return None, 0
    model = template_state.model
    try:
        with open(path, "rb") as f:
            bundle = flax_msgpack.restore(f.read())
        st = bundle["state"]
        params = {n: p for n, p in model.named_parameters()}
        sd = _matching(path, state_dict_from_flax({"params": st["params"], "batch_stats": st["batch_stats"]}),
                       model.state_dict(), "parameter or buffer of the model")
        ema = _matching(path, state_dict_from_flax({"params": st["ema_params"]}), params, "parameter of the model")
        adam = _find_adam(st["opt_state"])
        mu = _matching(path, state_dict_from_flax({"params": adam["mu"]}), params, "parameter of the model")
        nu = _matching(path, state_dict_from_flax({"params": adam["nu"]}), params, "parameter of the model")
        count, step, lr_scale, epoch = int(adam["count"]), int(st["step"]), float(st["lr_scale"]), int(bundle["epoch"])
    except Exception as e:
        print(f"corrupt train-state bundle {path} ({type(e).__name__}); ignoring")
        return None, 0
    dev = next(model.parameters()).device
    with torch.no_grad():
        model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
        for n, p in params.items():
            template_state.ema[n].copy_(ema[n])
            template_state.optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                                 "exp_avg": mu[n].to(dev), "exp_avg_sq": nu[n].to(dev)}
    template_state.step, template_state.lr_scale = step, lr_scale
    return template_state, epoch
