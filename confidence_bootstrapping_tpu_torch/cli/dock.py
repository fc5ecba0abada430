"""The docking CLI's model loading (``confidence_bootstrapping_tpu/cli/dock.py:65-110``).

``peek_model_config`` reads a model directory's config before any model
exists; ``load_or_init_model`` builds the model a directory describes and
loads its weights. A directory holds the port's or the JAX package's
``model_config.yml`` or a reference ``model_parameters.yml`` manifest, and a
Flax msgpack checkpoint (``train/checkpoints.py``). The CLI's ``main``
(featurization, sampling, ranked outputs) comes with the host layers.
"""

from __future__ import annotations

import os

from .. import yaml_io
from ..config import ScoreModelConfig, load_score_config
from ..models.factory import config_from_reference_manifest, get_model
from ..train import checkpoints

MANIFEST_NAME = "model_parameters.yml"  # the reference's argparse dump


def peek_model_config(model_dir, default_cfg=None):
    """A model directory's config, without building the model: its
    ``model_config.yml``, else its reference manifest translated, else
    ``default_cfg``."""
    if model_dir and os.path.exists(os.path.join(model_dir, checkpoints.CONFIG_NAME)):
        return load_score_config(os.path.join(model_dir, checkpoints.CONFIG_NAME))
    if model_dir and os.path.exists(os.path.join(model_dir, MANIFEST_NAME)):
        with open(os.path.join(model_dir, MANIFEST_NAME)) as f:
            return config_from_reference_manifest(yaml_io.load(f.read()) or {})
    return default_cfg


def load_or_init_model(model_dir, ckpt, default_cfg=None, device=None, seed: int = 0) -> tuple:
    """(model, config): the model a directory describes (``peek_model_config``;
    ``ScoreModelConfig()`` where it names none) with the weights of
    ``<model_dir>/<ckpt>.msgpack``, on ``device`` (default: the GPU). With
    no checkpoint the weights stay those drawn from ``seed``, with a warning.
    The port's modules hold their own weights, so unlike the JAX function no
    example batch is needed to initialize them. Raises ``ValueError`` for a
    config the port does not implement (``models.factory.get_model``) or a
    checkpoint that does not fit the model (``train.checkpoints.load_params``)."""
    cfg = peek_model_config(model_dir)
    if cfg is not None and not os.path.exists(os.path.join(model_dir, checkpoints.CONFIG_NAME)):
        print(f"translated reference manifest {model_dir}/{MANIFEST_NAME}")
    cfg = cfg or default_cfg or ScoreModelConfig()
    model = get_model(cfg, device=device, seed=seed)
    if model_dir and checkpoints.has_checkpoint(model_dir, ckpt):
        checkpoints.load_params(os.path.join(model_dir, f"{ckpt}.msgpack"), model)
        print(f"loaded weights from {model_dir}/{ckpt}.msgpack")
    else:
        print("WARNING: no checkpoint found - using randomly initialized weights")
    return model, cfg
