"""The confidence-model training CLI, on the GPU.

Port of ``confidence_bootstrapping_tpu/cli/confidence_train.py`` (the
reference's ``confidence/confidence_train.py``): generate (or load) the
frozen score model's rollout caches over the training complexes
(``--cache_creation_id`` makes one and exits; ``--cache_ids`` combines
several), then train the pose classifier (binary cross-entropy at one RMSD
cutoff, binned cross-entropy at several, or RMSD regression; balanced, the
2-4 A band left out; an optional per-atom head) and validate by accuracy and
ROC-AUC, keeping the best epoch (``confidence/train.train_confidence``).
``--transfer_weights`` builds the confidence model with the score model's
architecture and copies every matching tensor (``transfer_matching_variables``).
``--test`` sweeps the accuracy along the reverse diffusion and writes
``trajectory_sweep.json``. The workdir gets ``last_model`` and
``ema_model`` (Flax msgpack bundles), ``model_config.yml`` and
``history.pkl``.

Not ported: ``--affinity_prediction`` and ``--parallel`` > 1, which need the
legacy all-atom model's affinity head (``models/legacy``); they raise.

Randomness: one ``torch.Generator`` on the device, seeded by ``--seed``,
draws the rollouts, dropout and the sweep's samples (not the JAX package's
numbers); the datasets' picks draw from their own ``RandomState``s as the
JAX package's do. Runs on ``--device`` (default: the GPU; without a card it
raises unless ``--device cpu`` is given).

Example:
  python -m confidence_bootstrapping_tpu_torch.cli.confidence_train --data_dir data/ \\
      --original_model_dir workdir/pretrained_score --workdir workdir/confidence \\
      --samples_per_complex 8 --n_epochs 30
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle

import torch
from torch import nn

from ..bootstrapping.finetune import CBTarget
from ..config import TrainConfig, confidence_model_config, save_yaml
from ..confidence import dataset as cdataset
from ..confidence import train as ctrain
from ..data.dataset import ComplexDataset, discover_dir
from ..models.factory import get_model
from ..models.from_flax import flax_path
from ..runtime import resolve_device
from ..train import checkpoints
from .dock import load_or_init_model


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split_train", default=None)
    p.add_argument("--split_val", default=None)
    p.add_argument("--cache_path", default="cache")
    p.add_argument("--workdir", default="workdir/confidence")
    p.add_argument("--original_model_dir", required=True, help="frozen score model for pose generation")
    p.add_argument("--original_ckpt", default="last_model")
    p.add_argument("--samples_per_complex", type=int, default=4)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--cache_ids", default="1", help="comma-separated generation cache ids to combine")
    p.add_argument("--cache_creation_id", default=None, help="generate this cache id then exit")
    p.add_argument("--rmsd_classification_cutoff", type=float, nargs="+", default=[2.0],
                   help="one cutoff = binary BCE; several = multi-bin cross-entropy")
    p.add_argument("--rmsd_classification_upper", type=float, default=4.0)
    p.add_argument("--rmsd_prediction", action="store_true")
    p.add_argument("--no_balance", action="store_true")
    p.add_argument("--atom_confidence_loss_weight", type=float, default=0.0,
                   help="per-atom confidence loss weight (the pretrained recipe uses 0.5)")
    p.add_argument("--atom_rmsd_classification_cutoff", type=float, nargs="+", default=[2.0])
    p.add_argument("--confidence_loss_weight", type=float, default=1.0)
    p.add_argument("--affinity_prediction", action="store_true",
                   help="train a binding-affinity head jointly (needs models/legacy: not ported)")
    p.add_argument("--affinity_loss_weight", type=float, default=1.0)
    p.add_argument("--parallel", type=int, default=1,
                   help=">1 selects the legacy grouped-pose affinity head (not ported)")
    p.add_argument("--affinity_csv", default=None, help="CSV of 'complex_name,affinity' per line")
    p.add_argument("--transfer_weights", action="store_true",
                   help="build the confidence model with the SCORE model's architecture and initialize every "
                        "matching tensor from its checkpoint; heads stay fresh")
    p.add_argument("--trajectory_sampling", action="store_true",
                   help="train on random reverse-diffusion frames with their diffusion time stamped")
    p.add_argument("--all_atoms", action="store_true", default=True)
    p.add_argument("--ns", type=int, default=24)
    p.add_argument("--nv", type=int, default=6)
    p.add_argument("--n_epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--batches_per_epoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--test", action="store_true",
                   help="evaluation-only: sweep confidence accuracy over reverse-diffusion steps 0..T on the val "
                        "targets and write trajectory_sweep.json")
    p.add_argument("--ckpt", default="last_model", help="checkpoint (in --workdir) evaluated by --test")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def build_targets(args, names_file, all_atoms):
    names = open(names_file).read().split() if names_file else None
    entries = discover_dir(args.data_dir, names)
    if args.limit_complexes:
        entries = entries[: args.limit_complexes]
    ds = ComplexDataset(entries, cache_dir=args.cache_path, all_atoms=all_atoms)
    lm = ds.lm_dim()
    return [CBTarget(hc, ds.mols[hc.name], lm_dim=lm) for hc in ds.complexes]


def _variables(model: nn.Module) -> dict:
    """{(collection, Flax path): tensor} over the model's parameters
    ("params") and buffers ("batch_stats")."""
    params = dict(model.named_parameters())
    return {("params" if n in params else "batch_stats", flax_path(model, n)[0]): v
            for n, v in model.state_dict(keep_vars=True).items()}


@torch.no_grad()
def transfer_matching_variables(dst: nn.Module, src: nn.Module) -> int:
    """Copy into ``dst`` every parameter and batch statistic of ``src`` whose
    collection, Flax path (``models.from_flax.flax_path``), shape and dtype
    match one of ``dst``'s, as the JAX package's function copies Flax leaves
    (the reference's state_dict.update over intersecting keys,
    confidence_train.py:569-575). Returns the number copied."""
    theirs = _variables(src)
    n = 0
    for key, v in _variables(dst).items():
        s = theirs.get(key)
        if s is not None and s.shape == v.shape and s.dtype == v.dtype:
            v.copy_(s)
            n += 1
    return n


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.affinity_prediction or args.parallel > 1:
        raise NotImplementedError("--affinity_prediction and --parallel > 1 need the legacy all-atom model's "
                                  "affinity head (models/legacy), which the port has not yet (ROADMAP.md, Queue 1 "
                                  "item 7)")
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    # the frozen score model (its coarse-grained view of the complexes for generation)
    gen_targets = build_targets(args, args.split_train, all_atoms=False)
    score_model, score_cfg = load_or_init_model(args.original_model_dir, args.original_ckpt, device=dev)
    # the confidence model's view: all-atom unless the weights come from the (coarse-grained) score architecture
    conf_all_atoms = score_cfg.all_atoms if args.transfer_weights else args.all_atoms
    targets = build_targets(args, args.split_train, all_atoms=conf_all_atoms)
    val_targets = (build_targets(args, args.split_val, all_atoms=conf_all_atoms) if args.split_val
                   else targets[: max(1, len(targets) // 10)])
    print(f"confidence training: {len(targets)} train / {len(val_targets)} val complexes")

    gen_dir = os.path.join(args.cache_path, "confidence_generation")

    def cache_of(cache_id):
        return cdataset.generate_filtering_cache(score_model, gen_targets, generator, score_cfg,
                                                 args.samples_per_complex, args.inference_steps, gen_dir,
                                                 cache_id, trajectory=args.trajectory_sampling, device=dev)

    if args.cache_creation_id is not None:
        cache_of(args.cache_creation_id)
        print(f"generated cache id {args.cache_creation_id}")
        return
    cache = cdataset.combine_caches([cache_of(cid.strip()) for cid in args.cache_ids.split(",")])

    cutoff = args.rmsd_classification_cutoff
    if len(cutoff) == 1:
        cutoff = cutoff[0]  # the reference collapses single-element lists (:190-193)
    atom_cutoff = None
    if args.atom_confidence_loss_weight > 0:
        atom_cutoff = args.atom_rmsd_classification_cutoff
        if len(atom_cutoff) == 1:
            atom_cutoff = atom_cutoff[0]
    heads = dict(num_confidence_outputs=len(cutoff) + 1 if isinstance(cutoff, list) else 1,
                 atom_confidence=args.atom_confidence_loss_weight > 0,
                 atom_num_confidence_outputs=len(atom_cutoff) + 1 if isinstance(atom_cutoff, list) else 1)
    if args.transfer_weights:  # the score model's architecture, its matching weights (confidence_train.py:566-575)
        cfg = dataclasses.replace(score_cfg, confidence_mode=True, **heads)
    else:  # the ESM width the targets carry (none: the CLI featurizes no embeddings), as Flax infers it at init
        cfg = confidence_model_config(ns=args.ns, nv=args.nv, all_atoms=args.all_atoms,
                                      lm_embedding_dim=targets[0].lm_dim, **heads)
    model = get_model(cfg, device=dev)
    if args.transfer_weights:
        print(f"transferred {transfer_matching_variables(model, score_model)} matching parameter tensors from the "
              f"score model")

    kw = dict(rmsd_prediction=args.rmsd_prediction, atom_label_cutoff=atom_cutoff,
              trajectory_sampling=args.trajectory_sampling, device=dev)
    ds = cdataset.FilteringDataset(targets, cache, cutoff, None if args.rmsd_prediction else
                                   args.rmsd_classification_upper,
                                   balance=not args.no_balance and not isinstance(cutoff, list), **kw)
    val_ds = cdataset.FilteringDataset(val_targets, cache, cutoff, None, balance=False, **kw)
    print("train set:", ds.statistics())

    if args.test:  # evaluation only: the accuracy along the reverse diffusion (confidence_train.py:451-486)
        cmodel, _ = load_or_init_model(args.workdir, args.ckpt, cfg, device=dev)
        sweep = ctrain.trajectory_sweep(cmodel, score_model, val_targets, score_cfg, generator,
                                        inference_steps=args.inference_steps, samples=args.samples_per_complex,
                                        device=dev)
        out = os.path.join(args.workdir, "trajectory_sweep.json")
        with open(out, "w") as f:
            json.dump(sweep, f, indent=1)
        for row in sweep:
            print(f"step {row['step']:3d}: acc {row['accuracy']:.3f}  mean_rmsd {row['mean_rmsd']:.2f}  "
                  f"mean_score {row['mean_score']:.3f}")
        print("wrote", out)
        return sweep

    tcfg = TrainConfig(lr=args.lr, batch_size=args.batch_size)
    state, history = ctrain.train_confidence(
        model, ds, cache, tcfg, args.n_epochs, args.batches_per_epoch, generator, val_dataset=val_ds,
        val_cache=cache, rmsd_prediction=args.rmsd_prediction, confidence_loss_weight=args.confidence_loss_weight,
        atom_confidence_loss_weight=args.atom_confidence_loss_weight,
    )
    save_yaml(cfg, os.path.join(args.workdir, checkpoints.CONFIG_NAME))
    checkpoints.save_params(os.path.join(args.workdir, "last_model.msgpack"), state.model)
    checkpoints.save_params(os.path.join(args.workdir, "ema_model.msgpack"), state.model, params=state.ema)
    with open(os.path.join(args.workdir, "history.pkl"), "wb") as f:
        pickle.dump(history, f)
    print("saved confidence model to", args.workdir)
    return state, history


if __name__ == "__main__":
    main()
