"""The Confidence-Bootstrapping fine-tune CLI, on the GPU.

Port of ``confidence_bootstrapping_tpu/cli/finetune.py`` (the reference's
``finetune_train.py``): load a pretrained score model and a confidence
("filtering") model, build the target cluster's complexes (with receptor
atoms when the confidence model is all-atom), and run the rollout ->
confidence filter -> buffer -> fine-tune loop of
``bootstrapping/finetune.inference_finetune``. ``CBConfig`` comes from the
flags with the ``--config`` yaml on top (read by the port's ``yaml_io``).
The workdir gets ``last_model`` and ``ema_model`` (Flax msgpack bundles),
``metrics.pkl`` and ``final_filtered_rmsds.npy`` each epoch.

Randomness: one ``torch.Generator`` on the device, seeded by ``--seed``,
draws every rollout and training step (not the JAX package's numbers).
Runs on ``--device`` (default: the GPU; without a card it raises unless
``--device cpu`` is given). ``--data_parallel``: the rollouts and fine-tune
batches split over the ranks of ``torch.distributed`` (``parallel/mesh``;
torchrun's or the JAX package's environment), with the results of one
process; rank 0 alone writes the workdir.

Example (the recipe):
  python -m confidence_bootstrapping_tpu_torch.cli.finetune \\
      --data_dir <dockgen_dir> --cb_cluster <cluster> --cluster_map new_cluster_to_ligands.pkl \\
      --model_dir workdir/pretrained_score \\
      --confidence_model_dir workdir/pretrained_confidence \\
      --n_epochs 10 --inference_samples 8 --confidence_cutoff -4 \\
      --fixed_length 100
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle

import torch

from .. import yaml_io
from ..bootstrapping import finetune as ft
from ..config import CBConfig, ScoreModelConfig
from ..data.dataset import ComplexDataset, discover_dir
from ..parallel import mesh as meshlib
from ..runtime import resolve_device
from .dock import load_or_init_model, peek_model_config


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--cb_cluster", default=None, help="cluster name; with --cluster_map, selects its ligands")
    p.add_argument("--cluster_map", default=None, help="pickle {cluster: [complex names]} (new_cluster_to_ligands)")
    p.add_argument("--cache_path", default="cache")
    p.add_argument("--workdir", default="workdir/cb_finetune")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--ckpt", default="last_model")
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--confidence_ckpt", default="last_model")
    p.add_argument("--config", default=None, help="yaml overlay onto CBConfig")
    p.add_argument("--n_epochs", type=int, default=10)
    p.add_argument("--inference_samples", type=int, default=8)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--inference_batch_size", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16, help="finetune train batch size")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--confidence_cutoff", type=float, default=-4.0)
    p.add_argument("--cb_inference_freq", type=int, default=5)
    p.add_argument("--initial_iterations", type=int, default=5)
    p.add_argument("--inference_iterations", type=int, default=4)
    p.add_argument("--fixed_length", type=int, default=100)
    p.add_argument("--minimum_t", type=float, default=0.0)
    p.add_argument("--oracle_confidence", action="store_true")
    p.add_argument("--max_complexes_per_couple", type=int, default=5)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--buffer_decay", type=float, default=0.0)
    p.add_argument("--reset_buffer", action="store_true")
    p.add_argument("--sampling_mixing_coeff", type=float, default=0.0)
    p.add_argument("--sampling_alpha", type=float, default=2.0)
    p.add_argument("--sampling_beta", type=float, default=1.0)
    p.add_argument("--keep_original_train", action="store_true",
                   help="mix original-trainset batches into finetuning (paper-repro recipe)")
    p.add_argument("--original_train_dir", default=None)
    p.add_argument("--original_train_split", default=None)
    p.add_argument("--total_trainset_size", type=int, default=100)
    p.add_argument("--no_matching", action="store_true",
                   help="use the input SDF geometry for rollout targets instead of conformer-matched poses")
    p.add_argument("--matching_tries", type=int, default=1)
    p.add_argument("--matching_popsize", type=int, default=20)
    p.add_argument("--matching_maxiter", type=int, default=20)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard rollout and finetune batches over the torch.distributed ranks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def cb_config(args) -> CBConfig:
    """The loop's config: the flags, then the ``--config`` yaml over them."""
    cb_kwargs = dict(
        cb_cluster=args.cb_cluster or "", n_epochs=args.n_epochs, inference_samples=args.inference_samples,
        inference_steps=args.inference_steps, inference_batch_size=args.inference_batch_size,
        batch_size=args.batch_size, lr=args.lr, confidence_cutoff=args.confidence_cutoff,
        cb_inference_freq=args.cb_inference_freq, initial_iterations=args.initial_iterations,
        inference_iterations=args.inference_iterations, fixed_length=args.fixed_length, minimum_t=args.minimum_t,
        oracle_confidence=args.oracle_confidence, max_complexes_per_couple=args.max_complexes_per_couple,
        temperature=args.temperature, buffer_decay=args.buffer_decay, reset_buffer=args.reset_buffer,
        sampling_mixing_coeff=args.sampling_mixing_coeff, sampling_alpha=args.sampling_alpha,
        sampling_beta=args.sampling_beta,
    )
    if args.config:
        with open(args.config) as f:
            cb_kwargs.update(yaml_io.load(f.read()) or {})
    return CBConfig(**cb_kwargs)


def main(argv=None):
    args = get_parser().parse_args(argv)
    dp_mesh = None
    if args.data_parallel:
        meshlib.maybe_init_distributed(args.device)
        dp_mesh = meshlib.make_mesh(device=args.device)
        print(f"data-parallel CB loop over {dp_mesh.size} ranks")
    dev = dp_mesh.device if dp_mesh is not None else resolve_device(args.device)
    cb = cb_config(args)

    names = None
    if args.cluster_map and args.cb_cluster:
        with open(args.cluster_map, "rb") as f:
            names = pickle.load(f)[args.cb_cluster]
    entries = discover_dir(args.data_dir, names)
    if args.limit_complexes:
        entries = entries[: args.limit_complexes]
    matching_kwargs = dict(matching=not args.no_matching, matching_tries=args.matching_tries,
                           matching_popsize=args.matching_popsize, matching_maxiter=args.matching_maxiter)
    # an all-atom confidence (filtering) model needs receptor-atom graphs in the rollout batches
    conf_cfg = peek_model_config(args.confidence_model_dir) if args.confidence_model_dir else None
    need_atoms = bool(conf_cfg is not None and conf_cfg.all_atoms)
    ds = ComplexDataset(entries, cache_dir=args.cache_path, all_atoms=need_atoms, **matching_kwargs)
    lm = ds.lm_dim()
    targets = [ft.CBTarget(hc, ds.mols[hc.name], lm_dim=lm) for hc in ds.complexes]
    print(f"CB cluster '{cb.cb_cluster}': {len(targets)} target complexes")

    model, model_cfg = load_or_init_model(args.model_dir, args.ckpt, ScoreModelConfig(lm_embedding_dim=lm), device=dev)
    confidence_fn = None
    if args.confidence_model_dir and not cb.oracle_confidence:
        confidence_fn = ft.confidence_function(load_or_init_model(args.confidence_model_dir, args.confidence_ckpt,
                                                                  device=dev)[0])

    original_dataset = None
    if args.keep_original_train and args.original_train_dir:
        names_o = None
        if args.original_train_split:
            names_o = open(args.original_train_split).read().split()[: args.total_trainset_size]
        entries_o = discover_dir(args.original_train_dir, names_o)[: args.total_trainset_size]
        original_dataset = ComplexDataset(entries_o, cache_dir=args.cache_path, device=dev, **matching_kwargs)
        print(f"keep_original_train: {len(original_dataset)} original complexes mixed in")
        cb = dataclasses.replace(cb, keep_original_train=True)

    state, history = ft.inference_finetune(
        model, targets, model_cfg, cb, torch.Generator(device=dev).manual_seed(args.seed),
        confidence_fn=confidence_fn, workdir=args.workdir, original_dataset=original_dataset, device=dev,
        dp_mesh=dp_mesh,
    )
    print("CB finetune done;", history[-1])
    return state, history


if __name__ == "__main__":
    main()
