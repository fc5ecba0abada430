"""Carry the JAX package's model variables over to the port's modules.

Input: the Flax variables as a nested dict of numpy arrays,
``{"params": ..., "batch_stats": ...}``, as ``jax.tree.map(np.asarray,
variables)`` or ``train.flax_msgpack.restore`` of a checkpoint file gives
them; ``flax_from_state_dict`` maps a module back to that tree. The port's
module tree mirrors the Flax one, so each path maps mechanically:

* ``name_<i>`` (``conv_layers_0``, ``edge_mlps_1``, ``Dense_0``, ``Embed_3``,
  ``MaskedBatchNorm1d_1``) becomes ``name.<i>``, with ``Dense`` -> ``layers``,
  ``Embed`` -> ``embeddings`` and ``MaskedBatchNorm1d`` -> ``norms``;
* ``kernel`` [in, out] becomes ``weight`` [out, in] (transposed), Embed's
  ``embedding`` becomes ``weight``;
* batch statistics ``mean``/``var``/``norm`` become buffers of the same names;
  other parameters (batch norms' ``weight``/``bias``/``scale``) keep theirs.

This covers the score model (in score mode, and in confidence mode with its
``ConfidenceHead``s), the all-atom confidence model (its 4- and 9-group
``TPConv``s and its ``ConfidenceHead``s) and the legacy models (their
per-group conv lists, ``lig_conv_layers_0`` to ``ra_conv_layers_3``; the
old atom encoder's ``Embed_*`` and ``Dense_0``/``Dense_1``; the
``affinity_predictor``), and the equivariant linear maps
(``LinearIrreps``: a depthwise ``TPConv``'s ``linear_2`` and the
``sidechain_predictor``, whose parameters ``w_<i>_<o>``/``b_<o>`` keep their
names). Training adds no parameter
or buffer (dropout rates are plain attributes), so the same map carries a
JAX training state's parameters and batch statistics into the trainable
model, and its gradients into parameter names
(tests/test_torch_training.py).

Nothing here imports flax or msgpack; ``train/checkpoints.py`` reads and
writes the checkpoint files.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_RENAME = {"Dense": "layers", "Embed": "embeddings", "MaskedBatchNorm1d": "norms"}
_UNRENAME = {v: k for k, v in _RENAME.items()}


_NAMED = {"linear_2"}  # Flax module names that end in a number but are no list entry (a depthwise TPConv's linear map)


def _key(path) -> str:
    parts = []
    for i, p in enumerate(path):
        m = re.fullmatch(r"(.*)_(\d+)", p)
        if i == len(path) - 1:  # a leaf keeps its name (LinearIrreps' w_0_1, b_0), kernel and embedding aside
            parts.append({"kernel": "weight", "embedding": "weight"}.get(p, p))
        elif m and p not in _NAMED:
            parts += [_RENAME.get(m.group(1), m.group(1)), m.group(2)]
        else:
            parts.append(p)
    return ".".join(parts)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: dict) -> dict:
    """Flax variables -> a state_dict of float32 CPU tensors for the port."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            a = np.array(value, dtype=np.float32)  # a writable copy
            if path[-1] == "kernel":
                a = a.T
            sd[_key(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_flax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Copy Flax variables into ``model`` (strict: every key must match)."""
    sd = state_dict_from_flax(variables)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model


def flax_path(model: nn.Module, key: str) -> tuple:
    """(Flax path, whether the value is transposed) of a parameter or
    buffer name of ``model``: ``layers.i`` to ``Dense_i``, ``embeddings.i`` to
    ``Embed_i``, ``norms.i`` to ``MaskedBatchNorm1d_i``, another ``name.i`` to
    ``name_i``; a Linear's ``weight`` to ``kernel`` (transposed), an
    Embedding's to ``embedding``. The path ends with the leaf's name."""
    parts, path, mod = key.split("."), [], model
    k = 0
    while k < len(parts) - 1:
        if k + 1 < len(parts) - 1 and parts[k + 1].isdigit():
            path.append(f"{_UNRENAME.get(parts[k], parts[k])}_{parts[k + 1]}")
            mod = getattr(mod, parts[k])[int(parts[k + 1])]
            k += 2
        else:
            path.append(parts[k])
            mod = getattr(mod, parts[k])
            k += 1
    leaf = parts[-1]
    if leaf == "weight" and isinstance(mod, nn.Linear):
        return tuple(path) + ("kernel",), True
    if leaf == "weight" and isinstance(mod, nn.Embedding):
        return tuple(path) + ("embedding",), False
    return tuple(path) + (leaf,), False


def flax_tree(model: nn.Module, values: dict) -> dict:
    """A ``{name: tensor}`` dict over ``model``'s parameter or buffer names
    (the parameters themselves, their EMA copy, Adam's moments) as one Flax
    tree of float32 numpy arrays, keys in the module's order."""
    out = {}
    for key, value in values.items():
        path, transpose = flax_path(model, key)
        a = value.detach().to("cpu", torch.float32).numpy()
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(a.T if transpose else a, order="C")  # a copy: no memory shared with the module
    return out


def flax_from_state_dict(model: nn.Module, params: dict = None) -> dict:
    """``model``'s parameters and buffers as Flax variables: ``{"params":
    ..., "batch_stats": ...}`` of float32 numpy arrays in Flax's names and
    nesting (``flax_path``), the inverse of ``state_dict_from_flax``
    (parameters to ``params``, buffers to ``batch_stats``). ``params``, a
    ``{name: tensor}`` dict over every parameter (e.g. an EMA copy), stands
    in for the module's own parameters."""
    sd = model.state_dict()
    names = [k for k, _ in model.named_parameters()]
    buffers = {k: v for k, v in sd.items() if k not in set(names)}
    if params is not None:
        if set(params) != set(names):
            raise ValueError("params must hold a value for every parameter of the model, and nothing else")
        sd.update(params)
    out = {"params": flax_tree(model, {k: sd[k] for k in names}),
           "batch_stats": flax_tree(model, buffers)}
    return {c: tree for c, tree in out.items() if tree}
