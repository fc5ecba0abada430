"""The docking CLI: protein and ligand files to ranked poses, on the GPU.

Port of ``confidence_bootstrapping_tpu/cli/dock.py``. Featurize (a PDB, and a
ligand .sdf/.mol2 or a SMILES string) -> N poses at the diffusion prior ->
reverse diffusion -> optional confidence rerank -> ranked
``rank{k}_confidence{c}.sdf`` files and, with ``--save_visualisation``, a
``traj_{i}.pdb`` per pose. ``peek_model_config`` reads a model directory's
config before any model exists; ``load_or_init_model`` builds the model a
directory describes and loads its weights (the port's or the JAX package's
``model_config.yml``, or a reference ``model_parameters.yml`` manifest, with
a Flax msgpack checkpoint).

Randomness: one ``torch.Generator`` on the device, seeded from ``--seed``,
draws each batch's prior (``randomize_position``) and then its sampler
noise, batch after batch. The port does not draw the JAX package's numbers.
Runs on ``--device`` (default: the GPU; without a card it raises unless
``--device cpu`` is given).

Example:
  python -m confidence_bootstrapping_tpu_torch.cli.dock \\
      --protein_path data/1a0q/1a0q_protein_processed.pdb \\
      --ligand data/1a0q/1a0q_ligand.sdf --samples 8 --inference_steps 20
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import yaml_io
from ..config import SamplerConfig, ScoreModelConfig, load_score_config
from ..data import featurize, mol_io
from ..data.complex_graph import Bucket, HostComplex, pad_complex, pick_bucket, replicate_complex
from ..models.factory import config_from_reference_manifest, get_model
from ..runtime import resolve_device
from ..sampler import sampling
from ..train import checkpoints

MANIFEST_NAME = "model_parameters.yml"  # the reference's argparse dump


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--protein_path", default=None)
    p.add_argument("--protein_sequence", default=None,
                   help="sequence-only input: the structure is predicted with ESMFold (needs the `esm` package)")
    p.add_argument("--ligand", default=None, help="ligand .sdf/.mol/.mol2 path, or a SMILES string")
    p.add_argument("--protein_ligand_csv", default=None,
                   help="CSV with complex_name,protein_path,ligand_path columns (batch mode)")
    p.add_argument("--complex_name", default=None)
    p.add_argument("--out_dir", default="results/user_predictions")
    p.add_argument("--model_dir", default=None, help="dir with model_config.yml + weights")
    p.add_argument("--ckpt", default="last_model")
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--confidence_ckpt", default="last_model")
    p.add_argument("--samples_per_complex", "--samples", dest="samples", type=int, default=10)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--keep_input_conformer", action="store_true",
                   help="start from the input file's exact geometry instead of a regenerated conformer")
    p.add_argument("--no_final_step_noise", action="store_true")
    p.add_argument("--ode", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_visualisation", action="store_true")
    p.add_argument("--pocket_knowledge", action="store_true", help="initialize poses at the known pocket")
    p.add_argument("--pocket_cutoff", type=float, default=7.0)
    p.add_argument("--esm_embeddings_path", default=None, help=".pt dict of per-chain ESM2 embeddings")
    p.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain versions)")
    return p


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


def load_esm_for_structure(path, structure):
    """Per-chain ESM embeddings from a ``.pt`` dict (keyed by chain id or by
    sequence), concatenated in chain order; None without a path or where a
    chain has none."""
    if path is None:
        return None
    d = torch.load(path, map_location="cpu", weights_only=False)
    embs = []
    for cname in structure.chains():
        seq = structure.sequence(cname)
        for key in (cname, seq):
            if key in d:
                embs.append(np.asarray(d[key]))
                break
        else:
            return None
    return np.concatenate(embs, axis=0)


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.protein_ligand_csv:
        import csv

        results = {}
        with open(args.protein_ligand_csv) as f:
            for row in csv.DictReader(f):
                sub = argparse.Namespace(**vars(args))
                sub.protein_path = row.get("protein_path") or None
                sub.protein_sequence = row.get("protein_sequence") or None
                sub.ligand = row.get("ligand_path") or row.get("ligand_description")
                sub.complex_name = row.get("complex_name") or None
                sub.protein_ligand_csv = None
                _resolve_protein(sub)
                results[sub.complex_name or sub.ligand] = dock_one(sub)
        return results
    if not ((args.protein_path or args.protein_sequence) and args.ligand):
        raise SystemExit("provide --protein_path/--protein_sequence + --ligand, or --protein_ligand_csv")
    _resolve_protein(args)
    return dock_one(args)


def _resolve_protein(args):
    """Sequence-only input: predict the structure with ESMFold and dock
    against the prediction (``data.esm_prep.predict_structure``, which raises
    without the ``esm`` package)."""
    if args.protein_path or not args.protein_sequence:
        return
    from ..data.esm_prep import predict_structure

    name = args.complex_name or "complex"
    os.makedirs(os.path.join(args.out_dir, name), exist_ok=True)
    args.protein_path = predict_structure(
        args.protein_sequence, os.path.join(args.out_dir, name, f"{name}_esmfold.pdb")
    )
    print(f"ESMFold prediction written to {args.protein_path}")


class Docking(NamedTuple):
    """What ``prepare`` makes of one complex: the featurized complex, its
    heavy-atom molecule, its padding, the loaded models and the sampler's
    config with this receptor's phase plan."""

    name: str
    hc: HostComplex
    heavy: mol_io.Molecule
    bucket: Bucket
    padded: dict
    model: torch.nn.Module
    cfg: ScoreModelConfig
    sampler_cfg: SamplerConfig
    conf_model: Optional[torch.nn.Module]
    featurize_s: float


def complex_name(args) -> str:
    if args.complex_name:
        return args.complex_name
    if os.path.exists(args.ligand):
        return os.path.splitext(os.path.basename(args.ligand))[0]
    return "".join(c if c.isalnum() else "_" for c in args.ligand)[:60] or "ligand"  # a SMILES string


def featurize_complex(args, name: str, need_atoms: bool):
    """(HostComplex, heavy-atom Molecule, ESM embeddings or None) of the
    CLI's inputs, as the JAX CLI featurizes them: a ligand file's molecule
    docked from a regenerated conformer (``--keep_input_conformer``: from its
    own geometry), a SMILES string embedded from seed ``--seed``."""
    if os.path.exists(args.ligand):
        mol = mol_io.read_molecule(args.ligand)
        ligand_is_smiles = False
    else:
        from ..data.conformers import mol_from_smiles

        mol = mol_from_smiles(args.ligand, seed=args.seed)
        ligand_is_smiles = True
    structure = mol_io.parse_pdb(args.protein_path)
    lm = load_esm_for_structure(args.esm_embeddings_path, structure)
    conformer_mode = "input" if (args.keep_input_conformer or ligand_is_smiles) else "generate"
    hc = featurize.build_host_complex(name, mol, structure, lm_embeddings=lm, conformer_mode=conformer_mode,
                                      conformer_seed=args.seed, all_atoms=need_atoms)
    return hc, mol.remove_hs(), lm


def prepare(args, device) -> Docking:
    """Featurize, pad and load the models of one complex (``dock_one``'s
    set-up)."""
    name = complex_name(args)
    t0 = time.perf_counter()
    # an all-atom confidence model needs receptor-atom graphs in the batch
    conf_cfg = peek_model_config(args.confidence_model_dir) if args.confidence_model_dir else None
    need_atoms = bool(conf_cfg is not None and conf_cfg.all_atoms)
    hc, heavy, lm = featurize_complex(args, name, need_atoms)
    featurize_s = time.perf_counter() - t0

    n_lm = lm.shape[-1] if lm is not None else 0
    bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                         n_atoms=0 if hc.atom_f is None else len(hc.atom_f), all_atoms=need_atoms)
    padded = pad_complex(hc, bucket, lm_dim=n_lm)
    model, cfg = load_or_init_model(args.model_dir, args.ckpt, ScoreModelConfig(lm_embedding_dim=n_lm), device=device)
    if cfg.lm_embedding_dim != n_lm:
        raise ValueError(f"the score model reads ESM features of width {cfg.lm_embedding_dim}; the inputs give "
                         f"{n_lm} (--esm_embeddings_path)")
    conf_model = None
    if args.confidence_model_dir:
        conf_model, _ = load_or_init_model(args.confidence_model_dir, args.confidence_ckpt, device=device)
    print(f"featurized {name}: {len(hc.lig_f)} atoms, {len(hc.tor_src)} torsions, {len(hc.rec_f)} residues; bucket "
          f"{bucket}; featurization {featurize_s:.2f}s, set-up {time.perf_counter() - t0:.2f}s")
    sampler_cfg = SamplerConfig(inference_steps=args.inference_steps, no_final_step_noise=args.no_final_step_noise,
                                ode=args.ode)
    # the default-on phased receptor compaction: this receptor's plan
    sampler_cfg = sampling.with_derived_plan(cfg, sampler_cfg, padded["rec_pos"], padded["rec_mask"])
    return Docking(name, hc, heavy, bucket, padded, model, cfg, sampler_cfg, conf_model, featurize_s)


def dock_one(args):
    """Dock one complex -> (poses [samples, atoms, 3] in the receptor-centered
    frame, confidences [samples], NaN without a confidence model)."""
    dev = resolve_device(args.device)
    d = prepare(args, dev)
    hc, L = d.hc, len(d.hc.lig_f)
    out = os.path.join(args.out_dir, d.name)
    os.makedirs(out, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    pocket = featurize.pocket_center(hc, args.pocket_cutoff) if args.pocket_knowledge else None
    all_pos = []
    t1 = time.perf_counter()
    for start in range(0, args.samples, args.batch_size):
        n = min(args.batch_size, args.samples - start)
        batch = replicate_complex(d.padded, n, device=dev)
        pk = None if pocket is None else torch.as_tensor(np.broadcast_to(pocket, (n, 3)).copy(), device=dev)
        batch = sampling.randomize_position(batch, generator, d.cfg.sigma.tr_sigma_max, pocket_center=pk)
        final, traj = sampling.sample(d.model, batch, d.cfg, d.sampler_cfg, generator, args.save_visualisation,
                                      device=dev)
        all_pos.append(final.lig_pos[:, :L].cpu().numpy())
        if args.save_visualisation:
            tr = torch.cat([batch.lig_pos[None], traj], dim=0)[:, :, :L].cpu().numpy()
            for i in range(n):
                mol_io.write_pdb_trajectory(d.heavy, tr[:, i] + hc.orig_center,
                                            os.path.join(out, f"traj_{start + i}.pdb"))
    dt = time.perf_counter() - t1
    pos = np.concatenate(all_pos, axis=0)
    print(f"sampled {args.samples} poses x {args.inference_steps} steps in {dt:.2f}s ({args.samples / dt:.2f} poses/s)")

    if d.conf_model is not None:  # the rerank, in the confidence model's view of the complex
        t2, confs = time.perf_counter(), []
        for start in range(0, args.samples, args.batch_size):
            n = min(args.batch_size, args.samples - start)
            batch = replicate_complex(d.padded, n, device=dev)
            lp = batch.lig_pos.clone()
            lp[:, :L] = torch.as_tensor(pos[start: start + n], device=dev)
            confs.append(sampling.score_confidence(d.conf_model, batch, lig_pos=lp).cpu().numpy())
        conf = np.concatenate(confs, axis=0)
        print(f"reranked {args.samples} poses in {(time.perf_counter() - t2) * 1e3:.1f} ms")
    else:
        conf = np.full((args.samples,), np.nan)

    order = np.argsort(-np.nan_to_num(conf, nan=-1e9))
    for rank, i in enumerate(order):
        c = conf[i]
        suffix = f"_confidence{c:.2f}" if np.isfinite(c) else ""
        mol_io.write_sdf(d.heavy, pos[i] + hc.orig_center, os.path.join(out, f"rank{rank + 1}{suffix}.sdf"),
                         name=d.name)
    print(f"wrote {args.samples} ranked poses to {out}")
    return pos, conf


if __name__ == "__main__":
    main()
