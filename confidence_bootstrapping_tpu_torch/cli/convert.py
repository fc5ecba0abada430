"""Convert a reference checkpoint into a model directory of the port.

Port of ``confidence_bootstrapping_tpu/cli/convert.py``. Takes a reference
``.pt`` checkpoint (a raw ``state_dict``, a ``{epoch, model, optimizer,
ema_weights}`` bundle or a DataParallel ``module.``-prefixed dict) and the
``model_parameters.yml`` argparse manifest beside it, and writes
``model_config.yml`` and ``<out_name>.msgpack``, the directory every CLI
(``dock``, ``infer``, ``finetune``, ...) loads with
``cli.dock.load_or_init_model``:

    python -m confidence_bootstrapping_tpu_torch.cli.convert \\
        --checkpoint workdir/pretrained_score/best_ema_inference_epoch_model.pt \\
        --out_dir workdir/converted_score

A reference manifest names no flag for the legacy architectures (the
reference picks them at inference, ``inference.py --old_score_model``):
``--old_score_model`` converts to them (``models/legacy.py``), as
``cli.infer --old_score_model`` serves them. The weight map is
``models/convert.py``. The converted tree is loaded into
the architecture the manifest describes on the CPU (strict: every parameter
and buffer, nothing else) and written by ``train.checkpoints.save_params``:
the same bytes the JAX package's converter writes for the same file. The
manifest is read by the port's own yaml reader (``yaml_io``). Nothing runs on
the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from .. import yaml_io
from ..config import save_yaml
from ..models import convert as convert_mod
from ..models.factory import config_from_reference_manifest, get_model
from ..models.from_flax import load_flax_variables
from ..train import checkpoints

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="reference .pt checkpoint")
    p.add_argument("--model_parameters", default=None,
                   help="model_parameters.yml; defaults to the one next to the checkpoint")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--out_name", default="last_model", help="output checkpoint name (<name>.msgpack)")
    p.add_argument("--use_ema", action="store_true",
                   help="convert the bundle's ema_weights instead of the live model weights")
    p.add_argument("--old_score_model", action="store_true",
                   help="the checkpoint is of a legacy architecture (the reference's old_score_model.py or "
                        "old_all_atom_score_model.py, which its manifests do not name)")
    return p


def ema_state_dict(obj) -> dict:
    """A bundle's state dict with its EMA weights in place of the live ones.
    The reference's ExponentialMovingAverage keeps ``shadow_params`` as a
    list in ``parameters()`` order; zipped with the state dict's keys, or,
    where the list is shorter, with its keys that are not batch-norm buffers."""
    if not (isinstance(obj, dict) and "ema_weights" in obj):
        raise SystemExit("--use_ema requires a {model, ema_weights, ...} bundle checkpoint")
    sd = convert_mod.normalize_state_dict(obj)
    ema = obj["ema_weights"]
    shadow = ema["shadow_params"] if isinstance(ema, dict) else ema
    keys = list(sd)
    if len(shadow) != len(keys):
        keys = [k for k in keys if not k.endswith(BUFFERS)]
        if len(shadow) != len(keys):
            raise SystemExit(f"ema_weights has {len(shadow)} tensors but the model has {len(keys)} parameters - "
                             "cannot align")
    for k, v in zip(keys, shadow):
        sd[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
    return sd


def main(argv=None):
    args = get_parser().parse_args(argv)
    manifest_path = args.model_parameters or os.path.join(os.path.dirname(args.checkpoint), "model_parameters.yml")
    with open(manifest_path) as f:
        cfg = config_from_reference_manifest(yaml_io.load(f.read()) or {})
    if args.old_score_model:
        cfg = dataclasses.replace(cfg, old_score_model=True)
    obj = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    variables = convert_mod.convert_state_dict(ema_state_dict(obj) if args.use_ema else obj, cfg)
    model = load_flax_variables(get_model(cfg, device="cpu"), variables)
    os.makedirs(args.out_dir, exist_ok=True)
    save_yaml(cfg, os.path.join(args.out_dir, checkpoints.CONFIG_NAME))
    checkpoints.save_params(os.path.join(args.out_dir, f"{args.out_name}.msgpack"), model)
    n = len(model.state_dict())
    print(f"converted {args.checkpoint} -> {args.out_dir}/{args.out_name}.msgpack ({n} tensors)")
    return variables


if __name__ == "__main__":
    main()
