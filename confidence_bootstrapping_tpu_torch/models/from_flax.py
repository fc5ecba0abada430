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

This covers the score model and the all-atom confidence model (its 4- and
9-group ``TPConv``s and its ``ConfidenceHead``). Training adds no parameter
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


def _key(path) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"(.*)_(\d+)", p)
        if m:
            parts += [_RENAME.get(m.group(1), m.group(1)), m.group(2)]
        else:
            parts.append({"kernel": "weight", "embedding": "weight"}.get(p, p))
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


def flax_from_state_dict(model: nn.Module) -> dict:
    """``model``'s parameters and buffers as Flax variables: ``{"params":
    ..., "batch_stats": ...}`` of float32 numpy arrays in Flax's names and
    nesting, the inverse of ``state_dict_from_flax`` (parameters to
    ``params``, buffers to ``batch_stats``; ``layers.i`` to ``Dense_i``,
    ``embeddings.i`` to ``Embed_i``, ``norms.i`` to ``MaskedBatchNorm1d_i``,
    another ``name.i`` to ``name_i``; a Linear's ``weight`` to ``kernel``
    [in, out], transposed back, an Embedding's to ``embedding``)."""
    params = {k for k, _ in model.named_parameters()}
    out = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
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
        a = value.detach().to("cpu", torch.float32).numpy()
        leaf = parts[-1]
        if leaf == "weight" and isinstance(mod, nn.Linear):
            leaf, a = "kernel", a.T
        elif leaf == "weight" and isinstance(mod, nn.Embedding):
            leaf = "embedding"
        node = out["params" if key in params else "batch_stats"]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(a, order="C")  # a copy: the tree does not share the module's memory
    return {c: tree for c, tree in out.items() if tree}
