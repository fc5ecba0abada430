"""Carry the JAX package's model variables over to the port's modules.

Input: the Flax variables as a nested dict of numpy arrays,
``{"params": ..., "batch_stats": ...}``, as ``jax.tree.map(np.asarray,
variables)`` gives them. The port's module tree mirrors the Flax one, so each
path maps mechanically:

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

Nothing here imports flax or msgpack; reading a checkpoint file is not ported.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_RENAME = {"Dense": "layers", "Embed": "embeddings", "MaskedBatchNorm1d": "norms"}


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
