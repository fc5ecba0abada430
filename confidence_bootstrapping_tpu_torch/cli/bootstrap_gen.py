"""Generate an offline bootstrapping dataset, on the GPU.

Port of ``confidence_bootstrapping_tpu/cli/bootstrap_gen.py`` (the
reference's ``bootstrapping/bootstrapping.py`` cache-or-generate pipeline):
roll out a frozen score model on target complexes (a directory of
protein/ligand pairs, or PDB side-chain pseudo-complexes with random SMILES
ligands), keep the poses the confidence model scores above the cutoff, and
pickle them as ``{cache_path}/complexes_id{cache_id}.pkl`` for
``train --add_bootstrapping_dataset``.

Randomness: one ``torch.Generator`` on the device, seeded by ``--seed``,
draws every placement and the sampler's noise (not the JAX package's
numbers). Runs on ``--device`` (default: the GPU; without a card it raises
unless ``--device cpu`` is given).

Example:
  python -m confidence_bootstrapping_tpu_torch.cli.bootstrap_gen --data_dir data/ \\
      --model_dir workdir/pretrained_score --confidence_model_dir workdir/pretrained_confidence \\
      --samples_per_target 8 --confidence_cutoff -4
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from ..bootstrapping.finetune import CBTarget, confidence_function
from ..bootstrapping.offline_dataset import generate_bootstrapping_complexes
from ..config import ScoreModelConfig
from ..data.dataset import ComplexDataset, discover_dir
from ..runtime import resolve_device
from .dock import load_or_init_model, peek_model_config


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default=None, help="directory of {name}/{name}_ligand.sdf complexes")
    p.add_argument("--pdbsidechain_dir", default=None, help="PDB root for side-chain pseudo-complexes")
    p.add_argument("--smiles_file", default=None,
                   help="with --pdbsidechain_dir: file of SMILES, one per line, attached as random ligands")
    p.add_argument("--cache_path", default="cache")
    p.add_argument("--model_dir", required=True, help="frozen score model")
    p.add_argument("--ckpt", default="last_model")
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--confidence_ckpt", default="last_model")
    p.add_argument("--samples_per_target", type=int, default=4)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--confidence_cutoff", type=float, default=0.0)
    p.add_argument("--cache_id", default="1")
    p.add_argument("--out", default=None, help="output pickle (default {cache_path}/complexes_id{cache_id}.pkl)")
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def build_targets(args, need_atoms: bool):
    """The rollout targets: the complexes of ``--data_dir`` (receptor atoms
    when the confidence model is all-atom), or the side-chain
    pseudo-complexes of ``--pdbsidechain_dir`` with ``--smiles_file``'s
    molecules as random ligands."""
    if args.data_dir:
        entries = discover_dir(args.data_dir)
        if args.limit_complexes:
            entries = entries[: args.limit_complexes]
        ds = ComplexDataset(entries, cache_dir=args.cache_path, all_atoms=need_atoms)
        lm = ds.lm_dim()
        return [CBTarget(hc, ds.mols[hc.name], lm_dim=lm) for hc in ds.complexes]
    if args.pdbsidechain_dir:
        from ..data.pdb_sidechain import PDBSidechainDataset

        smiles = [s.strip() for s in open(args.smiles_file) if s.strip()] if args.smiles_file else None
        ds = PDBSidechainDataset(args.pdbsidechain_dir, limit_structures=args.limit_complexes or 0,
                                 add_random_ligand=smiles is not None, smiles_list=smiles)
        return [CBTarget(hc, ds.mols[hc.name]) for hc in ds.complexes]
    raise SystemExit("provide --data_dir or --pdbsidechain_dir")


def main(argv=None):
    args = get_parser().parse_args(argv)
    dev = resolve_device(args.device)
    conf_cfg = peek_model_config(args.confidence_model_dir) if args.confidence_model_dir else None
    need_atoms = bool(conf_cfg is not None and conf_cfg.all_atoms)
    targets = build_targets(args, need_atoms)
    print(f"bootstrapping generation over {len(targets)} targets")

    model, cfg = load_or_init_model(args.model_dir, args.ckpt, ScoreModelConfig(lm_embedding_dim=targets[0].lm_dim),
                                    device=dev)
    confidence_fn = None
    if args.confidence_model_dir:
        confidence_fn = confidence_function(load_or_init_model(args.confidence_model_dir, args.confidence_ckpt,
                                                               device=dev)[0])
    kept = generate_bootstrapping_complexes(
        model, targets, torch.Generator(device=dev).manual_seed(args.seed), cfg,
        samples_per_target=args.samples_per_target, inference_steps=args.inference_steps,
        confidence_fn=confidence_fn, confidence_cutoff=args.confidence_cutoff,
        cache_path=args.cache_path, cache_id=args.cache_id, device=dev,
    )
    out = args.out or os.path.join(args.cache_path, f"complexes_id{args.cache_id}.pkl")
    if args.out:  # generate_bootstrapping_complexes already wrote the cache copy
        with open(out, "wb") as f:
            pickle.dump(kept, f)
    print(f"kept {len(kept)} poses above cutoff {args.confidence_cutoff} -> {out}")
    return kept


if __name__ == "__main__":
    main()
