"""The benchmark evaluator CLI, on the GPU.

Port of ``confidence_bootstrapping_tpu/cli/infer.py``: evaluates a score
(and optionally a confidence) model over a set of complexes. Per complex:
featurization (cached under ``--cache_path`` with the JAX CLI's
``infer_{name}_*.pkl`` keys), a phase plan per receptor bucket, pose batches
with retry and batch halving, symmetry RMSDs, centroid distances, self
distances, the confidence rerank, the optional xtb relaxation and obrms
RMSDs; then the metrics dictionary (``eval/metrics.py``) and the JAX CLI's
artifacts (``metrics.json`` with the same keys, ``rmsds.npy``,
``centroid_distances.npy``, ``confidences.npy``, ``min_self_distances.npy``,
``run_times.npy``, ``complex_names.npy``, ``cold_variant.npy``, and
``poses/`` under ``--save_complexes``).

Complex sets are a CSV with columns ``complex_name,protein_path,ligand_path``
or a directory of ``{name}/{name}_protein_processed.pdb`` +
``{name}_ligand.sdf``. Randomness: one ``torch.Generator`` on the device,
seeded from ``--seed``, draws every prior and all sampler noise in order.
``cold_variant`` marks the first complex of each (shapes, phase plan, batch)
variant, as the JAX CLI does; the port compiles nothing per variant, so
there it only groups the run times. ``--old_score_model`` serves the legacy
architecture (``models/legacy.py``): a model directory written with it
(``cli.convert --old_score_model``), or seeded weights where there is no
checkpoint; a directory of the modern architecture is refused.
``--data_parallel`` shards each pose batch over the ranks of
``torch.distributed`` (``parallel/mesh``: started from torchrun's or the JAX
package's environment, one rank per device, ``cuda:LOCAL_RANK`` unless
``--device`` says otherwise); every rank draws the same prior and noise,
samples its slice and gathers the poses, so the results are the one-process
run's. A batch that does not split evenly runs whole on every rank. Rank 0
alone writes the artifacts; every rank returns the same metrics.
``--esm_embeddings_path`` (a ``.pt`` dict of
per-complex embeddings, as ``data.esm_prep.fold_esm_outputs`` writes it)
gives each complex its receptor features after featurization, so the cache
keys stay the JAX CLI's; the JAX CLI parses the flag but pads every receptor
to width 0. Runs on ``--device`` (default: the GPU; without a
card it raises unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pickle
import time
from typing import List, Tuple

import numpy as np
import torch

from ..config import SamplerConfig, ScoreModelConfig
from ..data import dataset as dataset_mod
from ..data import featurize, mol_io
from ..data.esm_prep import load_embeddings_pt
from ..data.complex_graph import _CacheUnpickler, pad_complex, pick_bucket, replicate_complex
from ..eval import metrics as metrics_mod
from ..eval import rmsd as rmsd_mod
from ..models.factory import get_model
from ..parallel import mesh as meshlib
from ..runtime import resolve_device
from ..sampler import sampling
from ..train import checkpoints
from .dock import load_or_init_model, peek_model_config


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--protein_ligand_csv", default=None)
    p.add_argument("--data_dir", default=None, help="dir of {name}/{name}_ligand.sdf etc.")
    p.add_argument("--names_file", default=None, help="optional list of complex names to evaluate")
    p.add_argument("--split", default="test")
    p.add_argument("--moad_splits_pkl", default=None,
                   help="MOAD_generalisation_splits.pkl: evaluate only the --split clusters")
    p.add_argument("--cluster_to_ligands_pkl", default=None)
    p.add_argument("--cache_path", default=None, help="featurization cache dir")
    p.add_argument("--protein_file", default="protein_processed", help="receptor file-name suffix in complex dirs")
    p.add_argument("--ligand_file", default="ligand", help="ligand file-name suffix in complex dirs")
    p.add_argument("--no_model", action="store_true",
                   help="random-pose baseline: evaluate the randomized start without the score model")
    p.add_argument("--no_rec_overlap_names", default=None,
                   help="file of complex names whose receptors are unseen in training; their metrics are "
                        "reported again with a no_overlap_ prefix")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--ckpt", default="last_model")
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--confidence_ckpt", default="last_model")
    p.add_argument("--samples_per_complex", type=int, default=10)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--rec_phase_plan", default="",
                   help="phased receptor compaction plan 'step:cap,step:cap' (e.g. '8:256'); entries with "
                        "cap >= the complex's receptor bucket are dropped; 'off' disables the derived plan")
    p.add_argument("--per_complex_phase_plan", action="store_true",
                   help="derive the phase plan per complex instead of once per receptor bucket")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--limit_failures", type=int, default=5)
    p.add_argument("--keep_input_conformer", action="store_true",
                   help="start sampling from the input SDF geometry instead of a regenerated conformer")
    p.add_argument("--resample_rdkit", action="store_true",
                   help="regenerate a fresh conformer per pose instead of one shared")
    p.add_argument("--crop_res_cap", type=int, default=0,
                   help="override the confidence model's crop-compaction residue bucket (0 = its config value)")
    p.add_argument("--crop_atom_cap", type=int, default=0,
                   help="override the confidence model's crop-compaction atom bucket")
    p.add_argument("--cross_cap", type=int, default=0,
                   help="pin the per-ligand-atom receptor-neighbour capacity of the cross group (0 = the "
                        "model's); telemetry in metrics.json")
    p.add_argument("--old_score_model", action="store_true",
                   help="the legacy pre-protein-embedding architecture (the reference's inference.py "
                        "--old_score_model)")
    p.add_argument("--no_final_step_noise", action="store_true")
    p.add_argument("--ode", action="store_true")
    p.add_argument("--temp_sampling_tr", type=float, default=1.0)
    p.add_argument("--temp_sampling_rot", type=float, default=1.0)
    p.add_argument("--temp_sampling_tor", type=float, default=1.0)
    p.add_argument("--temp_psi_tr", type=float, default=0.0)
    p.add_argument("--temp_psi_rot", type=float, default=0.0)
    p.add_argument("--temp_psi_tor", type=float, default=0.0)
    p.add_argument("--temp_sigma_data", type=float, default=0.5)
    p.add_argument("--sigma_schedule", default="expbeta")
    p.add_argument("--inf_sched_alpha", type=float, default=1.0)
    p.add_argument("--inf_sched_beta", type=float, default=1.0)
    p.add_argument("--actual_steps", type=int, default=None,
                   help="run only the first N entries of the inference_steps-long schedule")
    p.add_argument("--different_schedules", action="store_true")
    p.add_argument("--rot_sigma_schedule", default="expbeta")
    p.add_argument("--rot_inf_sched_alpha", type=float, default=1.0)
    p.add_argument("--rot_inf_sched_beta", type=float, default=1.0)
    p.add_argument("--tor_sigma_schedule", default="expbeta")
    p.add_argument("--tor_inf_sched_alpha", type=float, default=1.0)
    p.add_argument("--tor_inf_sched_beta", type=float, default=1.0)
    p.add_argument("--initial_noise_std_proportion", type=float, default=1.0)
    p.add_argument("--pocket_knowledge", action="store_true")
    p.add_argument("--pocket_cutoff", type=float, default=7.0)
    p.add_argument("--pocket_tr_max", type=float, default=3.0,
                   help="initial translation noise std around the pocket center; with --different_schedules it "
                        "also caps the tr time grid")
    p.add_argument("--no_random_pocket", action="store_true", help="skip the random initial translation in pocket mode")
    p.add_argument("--svgd_weight_log_0", type=float, default=None)
    p.add_argument("--svgd_weight_log_1", type=float, default=None)
    p.add_argument("--svgd_repulsive_weight_log_0", type=float, default=None)
    p.add_argument("--svgd_repulsive_weight_log_1", type=float, default=None)
    p.add_argument("--svgd_kernel_size_log_0", type=float, default=None)
    p.add_argument("--svgd_kernel_size_log_1", type=float, default=None)
    p.add_argument("--svgd_langevin_weight_log_0", type=float, default=None)
    p.add_argument("--svgd_langevin_weight_log_1", type=float, default=None)
    p.add_argument("--svgd_rot_log_rel_weight", type=float, default=0.0)
    p.add_argument("--svgd_tor_log_rel_weight", type=float, default=0.0)
    p.add_argument("--svgd_use_x0", action="store_true")
    p.add_argument("--xtb", action="store_true", help="relax sampled poses with the xtb binary when present")
    p.add_argument("--obrms", action="store_true", help="also compute obrms (OpenBabel) RMSDs when the binary is present")
    p.add_argument("--save_complexes", action="store_true", help="save all sampled poses per complex as npy")
    p.add_argument("--save_visualisation", action="store_true",
                   help="write reverse-diffusion trajectory PDBs per pose")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard each pose batch over the torch.distributed ranks (torchrun, or the JAX "
                        "package's JAX_COORDINATOR_ADDRESS contract)")
    p.add_argument("--out_dir", default="results/eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--esm_embeddings_path", default=None, help=".pt dict of per-complex ESM2 embeddings")
    p.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def discover_complexes(args) -> List[Tuple[str, str, str]]:
    """(name, protein path, ligand path) of every complex to evaluate."""
    out = []
    if args.protein_ligand_csv:
        import csv

        with open(args.protein_ligand_csv) as f:
            for row in csv.DictReader(f):
                out.append((row["complex_name"], row["protein_path"], row["ligand_path"]))
    elif args.data_dir:
        names = sorted(os.listdir(args.data_dir))
        if args.names_file:
            keep = set(open(args.names_file).read().split())
            names = [n for n in names if n in keep]
        if args.moad_splits_pkl and args.cluster_to_ligands_pkl:
            from ..data import moad as moad_mod

            clusters = moad_mod.load_cluster_splits(args.moad_splits_pkl, args.split)
            c2l = moad_mod.load_cluster_to_ligands(args.cluster_to_ligands_pkl)
            keep = {n for c in clusters for n in c2l.get(c, [])}
            names = [n for n in names if n in keep]
        for n in names:
            d = os.path.join(args.data_dir, n)
            prot = os.path.join(d, f"{n}_{args.protein_file}.pdb")
            lig = os.path.join(d, f"{n}_{args.ligand_file}.sdf")
            if not os.path.exists(lig):
                lig = os.path.join(d, f"{n}_{args.ligand_file}.mol2")
            if os.path.exists(prot) and os.path.exists(lig):
                out.append((n, prot, lig))
    else:
        raise SystemExit("provide --protein_ligand_csv or --data_dir")
    if args.limit_complexes:
        out = out[: args.limit_complexes]
    return out


def featurize_cached(args, name: str, prot_path: str, lig_path: str, need_atoms: bool):
    """(HostComplex, heavy-atom Molecule) of one complex, from the cache under
    ``--cache_path`` when it is there (the JAX CLI's key, so either package
    reads the other's files), else featurized from a regenerated conformer
    (``--keep_input_conformer``: the input geometry) and written there."""
    conformer_mode = "input" if args.keep_input_conformer else "generate"
    cache_file = None
    if args.cache_path:
        params = (name, prot_path, lig_path, conformer_mode, args.seed, need_atoms)
        h = hashlib.sha1(repr(params).encode()).hexdigest()[:16]
        os.makedirs(args.cache_path, exist_ok=True)
        cache_file = os.path.join(args.cache_path, f"infer_{name}_{h}.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                return _CacheUnpickler(f).load()
    mol = mol_io.read_molecule(lig_path)
    structure = mol_io.parse_pdb(prot_path)
    hc = featurize.build_host_complex(name, mol, structure, conformer_mode=conformer_mode, conformer_seed=args.seed,
                                      all_atoms=need_atoms)
    heavy = mol.remove_hs()
    alts = dataset_mod.discover_alt_poses(lig_path, heavy.num_atoms)
    if alts:
        hc = hc._replace(alt_orig_lig_pos=np.stack(alts) - hc.orig_center[None, None])
    if cache_file:
        tmp = f"{cache_file}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump((hc, heavy), f)
        os.replace(tmp, cache_file)
    return hc, heavy


def sampler_config(args) -> SamplerConfig:
    return SamplerConfig(
        inference_steps=args.inference_steps,
        actual_steps=args.actual_steps,
        no_final_step_noise=args.no_final_step_noise,
        ode=args.ode,
        sigma_schedule=args.sigma_schedule,
        inf_sched_alpha=args.inf_sched_alpha,
        inf_sched_beta=args.inf_sched_beta,
        different_schedules=args.different_schedules,
        rot_sigma_schedule=args.rot_sigma_schedule,
        rot_inf_sched_alpha=args.rot_inf_sched_alpha,
        rot_inf_sched_beta=args.rot_inf_sched_beta,
        tor_sigma_schedule=args.tor_sigma_schedule,
        tor_inf_sched_alpha=args.tor_inf_sched_alpha,
        tor_inf_sched_beta=args.tor_inf_sched_beta,
        temp_sampling=(args.temp_sampling_tr, args.temp_sampling_rot, args.temp_sampling_tor),
        temp_psi=(args.temp_psi_tr, args.temp_psi_rot, args.temp_psi_tor),
        temp_sigma_data=args.temp_sigma_data,
        initial_noise_std_proportion=args.initial_noise_std_proportion,
        svgd_weight_log_0=args.svgd_weight_log_0,
        svgd_weight_log_1=args.svgd_weight_log_1,
        svgd_repulsive_weight_log_0=args.svgd_repulsive_weight_log_0,
        svgd_repulsive_weight_log_1=args.svgd_repulsive_weight_log_1,
        svgd_kernel_size_log_0=args.svgd_kernel_size_log_0,
        svgd_kernel_size_log_1=args.svgd_kernel_size_log_1,
        svgd_langevin_weight_log_0=args.svgd_langevin_weight_log_0,
        svgd_langevin_weight_log_1=args.svgd_langevin_weight_log_1,
        svgd_rot_log_rel_weight=args.svgd_rot_log_rel_weight,
        svgd_tor_log_rel_weight=args.svgd_tor_log_rel_weight,
        svgd_use_x0=args.svgd_use_x0,
    )


def with_config(model, cfg):
    """A model of config ``cfg`` with ``model``'s weights (a capacity
    override: the weights do not depend on it)."""
    out = get_model(cfg, device=next(model.parameters()).device)
    out.load_state_dict(model.state_dict())
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    dp_mesh = None
    if args.data_parallel:
        meshlib.maybe_init_distributed(args.device)
        dp_mesh = meshlib.make_mesh(device=args.device)
        print(f"data-parallel sampling over {dp_mesh.size} ranks")
    dev = dp_mesh.device if dp_mesh is not None else resolve_device(args.device)
    writer = dp_mesh is None or dp_mesh.rank == 0  # rank 0 alone writes the artifacts
    if writer:
        os.makedirs(args.out_dir, exist_ok=True)
    complexes = discover_complexes(args)
    print(f"evaluating {len(complexes)} complexes, {args.samples_per_complex} poses each on {dev}")

    N = args.samples_per_complex
    sampler_cfg = sampler_config(args)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    lm_embeddings = load_embeddings_pt(args.esm_embeddings_path) if args.esm_embeddings_path else None
    model = cfg = cmodel = None
    # an all-atom confidence model needs receptor-atom graphs in every batch
    conf_cfg = peek_model_config(args.confidence_model_dir) if args.confidence_model_dir else None
    need_atoms = bool(conf_cfg is not None and conf_cfg.all_atoms)
    names, all_rmsds, all_centroids, all_confidences, all_self, run_times = [], [], [], [], [], []
    overflow_stats = []
    failures = 0
    plan_by_bucket = {}  # receptor bucket -> the first derived phase plan, reused
    seen_variants = set()
    variant_cold, sample_walls, conf_walls, metrics_walls = [], [], [], []

    for name, prot_path, lig_path in complexes:
        try:
            hc, heavy = featurize_cached(args, name, prot_path, lig_path, need_atoms)
            if lm_embeddings is not None:
                lm = np.asarray(lm_embeddings[name], dtype=np.float32)
                if len(lm) < len(hc.rec_f):
                    raise ValueError(f"LM embeddings ({len(lm)}) shorter than residues ({len(hc.rec_f)})")
                hc = hc._replace(rec_lm=lm[: len(hc.rec_f)])
            n_lm, L = hc.rec_lm.shape[-1], len(hc.lig_f)
            bucket = pick_bucket(L, len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                                 n_atoms=0 if hc.atom_f is None else len(hc.atom_f), all_atoms=need_atoms)
            padded = pad_complex(hc, bucket, lm_dim=n_lm)

            sc_local = sampler_cfg
            if args.rec_phase_plan and args.rec_phase_plan != "off":
                plan = [(int(x.split(":")[0]), int(x.split(":")[1])) for x in args.rec_phase_plan.split(",") if x]
                plan = [(s, c) for s, c in plan if c < bucket.N]
                if plan:
                    sc_local = dataclasses.replace(sampler_cfg, rec_phase_steps=tuple(s for s, _ in plan),
                                                   rec_phase_caps=tuple(c for _, c in plan))

            if model is None:
                model, cfg = load_or_init_model(args.model_dir, args.ckpt,
                                                ScoreModelConfig(lm_embedding_dim=n_lm,
                                                                 old_score_model=args.old_score_model), device=dev)
                if args.old_score_model and not cfg.old_score_model:
                    if args.model_dir and checkpoints.has_checkpoint(args.model_dir, args.ckpt):
                        raise SystemExit(
                            f"--old_score_model was passed, but the checkpoint in {args.model_dir} was saved with "
                            "the modern architecture (its config lacks old_score_model). Its weights do not fit the "
                            "legacy model: drop --old_score_model or point --model_dir at a legacy checkpoint (e.g. "
                            "one written by `cli.convert --old_score_model`).")
                    cfg = dataclasses.replace(cfg, old_score_model=True)  # no checkpoint: seeded legacy weights
                    model = get_model(cfg, device=dev)
                if args.cross_cap:  # pins the exact cap (no bucket-scaled cross_cap_frac)
                    cfg = dataclasses.replace(cfg, cross_cap=args.cross_cap, cross_cap_frac=0.0)
                    model = with_config(model, cfg)
                if args.confidence_model_dir:
                    cmodel, ccfg = load_or_init_model(args.confidence_model_dir, args.confidence_ckpt, device=dev)
                    if args.crop_res_cap or args.crop_atom_cap:
                        cmodel = with_config(cmodel, dataclasses.replace(
                            ccfg, crop_res_cap=args.crop_res_cap or ccfg.crop_res_cap,
                            crop_atom_cap=args.crop_atom_cap or ccfg.crop_atom_cap))
                if args.pocket_knowledge and args.different_schedules:
                    # shrink the tr grid so sigma_tr never exceeds pocket_tr_max
                    t_max = (np.log(args.pocket_tr_max) - np.log(cfg.sigma.tr_sigma_min)) / (
                        np.log(cfg.sigma.tr_sigma_max) - np.log(cfg.sigma.tr_sigma_min))
                    sampler_cfg = dataclasses.replace(sampler_cfg, t_max=float(t_max))

            if cfg.lm_embedding_dim != n_lm:
                raise ValueError(f"the score model reads ESM features of width {cfg.lm_embedding_dim}; {name} has "
                                 f"{n_lm} (--esm_embeddings_path)")

            # no explicit plan: derive one per receptor bucket from its first complex ('off' disables)
            if not args.rec_phase_plan and sampler_cfg.rec_phase_auto and not sc_local.rec_phase_steps:
                bkey = int(padded["rec_pos"].shape[-2])
                if not args.per_complex_phase_plan and bkey in plan_by_bucket:
                    steps_a, caps_a = plan_by_bucket[bkey]
                else:
                    steps_a, caps_a = sampling.derive_phase_plan(cfg, sampler_cfg, padded["rec_pos"],
                                                                 padded["rec_mask"])
                    plan_by_bucket[bkey] = (steps_a, caps_a)
                if steps_a:
                    sc_local = dataclasses.replace(sampler_cfg, rec_phase_steps=steps_a, rec_phase_caps=caps_a)

            overflow_stats.append(sampling.cross_overflow_stats(replicate_complex(padded, 1, device=dev), cfg))

            sig = (tuple(sorted((k_, tuple(v.shape)) for k_, v in padded.items() if hasattr(v, "shape"))),
                   sc_local.rec_phase_steps, sc_local.rec_phase_caps, min(args.batch_size, N))
            variant_cold.append(sig not in seen_variants)
            seen_variants.add(sig)

            t0 = time.time()
            t_sample = t_conf = 0.0
            poses_list, confs_list = [], []
            bs = min(args.batch_size, N)
            start = 0
            local_fail = 0
            pocket = featurize.pocket_center(hc, args.pocket_cutoff) if args.pocket_knowledge else None
            while start < N:
                n = min(bs, N - start)
                try:
                    batch = replicate_complex(padded, n, device=dev)
                    if args.resample_rdkit:  # a fresh conformer per pose instead of one shared
                        from ..data import conformers as conf_mod

                        newpos = batch.lig_pos.cpu().numpy().copy()
                        for i in range(n):
                            g = conf_mod.generate_conformer(heavy, seed=args.seed * 100003 + start + i)
                            newpos[i, :L] = g - g.mean(0) + newpos[i, :L].mean(0)
                        batch = batch.replace(lig_pos=torch.as_tensor(newpos, device=dev))
                    # pocket mode: start around the pocket center with the small pocket_tr_max noise std;
                    # --no_random_pocket drops the noise
                    pk = None if pocket is None else torch.as_tensor(np.broadcast_to(pocket, (n, 3)).copy(), device=dev)
                    batch = sampling.randomize_position(
                        batch, generator, args.pocket_tr_max if args.pocket_knowledge else cfg.sigma.tr_sigma_max,
                        no_random=args.pocket_knowledge and args.no_random_pocket, pocket_center=pk,
                        initial_noise_std_proportion=args.initial_noise_std_proportion)
                    t_s0 = time.time()
                    if args.no_model:  # the random-pose baseline: score the randomized start
                        final, traj = batch, None
                    else:
                        final, traj = sampling.sample(model, batch, cfg, sc_local, generator,
                                                      args.save_visualisation, device=dev, mesh=dp_mesh)
                    pos = final.lig_pos[:, :L].cpu().numpy()  # a sync point
                    t_sample += time.time() - t_s0
                    if args.save_visualisation and traj is not None and writer:
                        tr = torch.cat([batch.lig_pos[None], traj], dim=0)[:, :, :L].cpu().numpy()
                        vis_dir = os.path.join(args.out_dir, "visualisation", name)
                        os.makedirs(vis_dir, exist_ok=True)
                        for i in range(n):
                            mol_io.write_pdb_trajectory(heavy, tr[:, i] + hc.orig_center,
                                                        os.path.join(vis_dir, f"traj_{start + i}.pdb"))
                    t_c0 = time.time()
                    if cmodel is not None:
                        conf = sampling.score_confidence(cmodel, final).cpu().numpy()
                    else:
                        conf = np.zeros(n)
                    t_conf += time.time() - t_c0
                    poses_list.append(pos)
                    confs_list.append(conf)
                    start += n
                except Exception as e:  # retry with a halved batch
                    local_fail += 1
                    bs = max(1, bs // 2)
                    print(f"{name}: batch failed ({type(e).__name__}), halving to {bs}")
                    if local_fail > args.limit_failures:
                        raise
            run_times.append(time.time() - t0)
            sample_walls.append(t_sample)
            conf_walls.append(t_conf)

            t_m0 = time.time()
            poses = np.concatenate(poses_list)
            confs = np.concatenate(confs_list)
            if args.xtb:
                from ..eval import relax as relax_mod

                for i in range(len(poses)):
                    relaxed = relax_mod.xtb_relax(heavy, poses[i])
                    if relaxed is not None:
                        poses[i] = relaxed
            rmsds = rmsd_mod.symmetry_rmsd(rmsd_mod.ground_truth_poses(hc), poses, heavy.atomic_nums, heavy.bonds)
            if args.obrms:
                from ..eval import relax as relax_mod

                # the poses are in the centered frame, the ligand file in absolute coordinates
                ob = relax_mod.obrms(lig_path, heavy, poses + np.asarray(hc.orig_center))
                if ob is not None:
                    print(f"{name}: obrms mean {ob.mean():.2f} A (sym-rmsd mean {rmsds.mean():.2f} A)")
            cent = np.linalg.norm(poses.mean(axis=1) - hc.orig_lig_pos.mean(axis=0), axis=-1)
            self_d = np.asarray([metrics_mod.min_self_distance(p, heavy.bonds) for p in poses])
            metrics_walls.append(time.time() - t_m0)

            names.append(name)
            all_rmsds.append(rmsds)
            all_centroids.append(cent)
            all_confidences.append(confs)
            all_self.append(self_d)
            if args.save_complexes and writer:
                os.makedirs(f"{args.out_dir}/poses", exist_ok=True)
                np.save(f"{args.out_dir}/poses/{name}.npy", poses)
            print(f"{name}: min rmsd {rmsds.min():.2f} A, top-conf rmsd {rmsds[np.argmax(confs)]:.2f} A, "
                  f"{run_times[-1]:.1f}s")
        except Exception as e:
            failures += 1
            # the failed complex's sentinels, as the JAX CLI writes them
            names.append(name)
            all_rmsds.append(np.full(N, 10000.0))
            all_centroids.append(np.full(N, 10000.0))
            all_confidences.append(np.full(N, -1e-6))
            all_self.append(np.full(N, np.inf))
            run_times.append(0.0)
            for lst, fill in ((variant_cold, False), (sample_walls, 0.0), (conf_walls, 0.0), (metrics_walls, 0.0)):
                while len(lst) < len(names):
                    lst.append(fill)
            print(f"FAILED {name}: {type(e).__name__}: {e}")
            if failures > args.limit_failures:
                raise

    rmsds = np.stack(all_rmsds)
    centroids = np.stack(all_centroids)
    confidences = np.stack(all_confidences)
    self_d = np.stack(all_self)
    run_times = np.asarray(run_times)

    if writer:
        np.save(f"{args.out_dir}/rmsds.npy", rmsds)
        np.save(f"{args.out_dir}/centroid_distances.npy", centroids)
        np.save(f"{args.out_dir}/confidences.npy", confidences)
        np.save(f"{args.out_dir}/min_self_distances.npy", self_d)
        np.save(f"{args.out_dir}/run_times.npy", run_times)
        np.save(f"{args.out_dir}/complex_names.npy", np.asarray(names))

    m = metrics_mod.performance_metrics(rmsds, centroids, confidences if cmodel is not None else None, self_d,
                                        run_times)
    if args.no_rec_overlap_names:  # a second pass over the receptor-unseen subset
        keep = set(open(args.no_rec_overlap_names).read().split())
        sel = np.asarray([n in keep for n in names])
        if sel.any():
            m.update(metrics_mod.performance_metrics(
                rmsds[sel], centroids[sel], confidences[sel] if cmodel is not None else None,
                self_d[sel], run_times[sel], prefix="no_overlap_"))
            m["no_overlap_n_complexes"] = int(sel.sum())
    m["n_complexes"] = len(names)
    m["failures"] = failures
    m["poses_per_sec"] = round(float(len(names) * N / max(run_times.sum(), 1e-9)), 3)
    cold = np.asarray(variant_cold, dtype=bool)
    if writer:
        np.save(f"{args.out_dir}/cold_variant.npy", cold)
    warm_sel = (~cold) & (run_times > 0)
    m["n_variant_compiles"] = int(cold.sum())
    if warm_sel.any():
        m["run_times_warm_mean"] = round(float(run_times[warm_sel].mean()), 3)
        m["run_times_warm_std"] = round(float(run_times[warm_sel].std()), 3)
        m["poses_per_sec_warm"] = round(float(warm_sel.sum() * N / max(run_times[warm_sel].sum(), 1e-9)), 3)
    m["wall_breakdown_s"] = {
        "sample": round(float(np.sum(sample_walls)), 1),
        "confidence": round(float(np.sum(conf_walls)), 1),
        "host_metrics": round(float(np.sum(metrics_walls)), 1),
        "sample_warm": round(float(np.asarray(sample_walls)[warm_sel].sum()), 1) if warm_sel.any() else 0.0,
        "confidence_warm": round(float(np.asarray(conf_walls)[warm_sel].sum()), 1) if warm_sel.any() else 0.0,
    }
    if overflow_stats:
        drop = float(np.mean([s["dropped_edge_frac"] for s in overflow_stats]))
        drop_f = float(np.mean([s.get("dropped_edge_frac_final", 0.0) for s in overflow_stats]))
        m["cross_cap"] = int(getattr(cfg, "cross_cap", 48))
        m["cross_cap_frac"] = float(getattr(cfg, "cross_cap_frac", 0.0))
        m["cross_cap_dropped_edge_frac"] = round(drop, 5)
        m["cross_cap_overflow_atom_frac"] = round(float(np.mean([s["overflow_atom_frac"] for s in overflow_stats])), 5)
        # at the final step's cutoff: the truncation that matters for the pose's refinement
        m["cross_cap_dropped_edge_frac_final"] = round(drop_f, 5)
        m["cross_cap_overflow_atom_frac_final"] = round(
            float(np.mean([s.get("overflow_atom_frac_final", 0.0) for s in overflow_stats])), 5)
        if drop_f > 0.01:
            print(f"WARNING: cross-edge cap {m['cross_cap']} truncates {drop_f:.1%} of in-radius "
                  f"edges even at the FINAL-step cutoff - consider --cross_cap {2 * m['cross_cap']}")
    if writer:
        with open(f"{args.out_dir}/metrics.json", "w") as f:
            json.dump(m, f, indent=2)
        write_ecdf(args.out_dir, rmsds, confidences)
    if dp_mesh is not None:  # the others wait for rank 0's files, then take its metrics (and their walls)
        meshlib.coordinator_barrier("infer_artifacts")
        m = meshlib.broadcast_object(dp_mesh, m)
    for k, v in sorted(m.items()):
        print(f"{k}: {v}")
    return m


def write_ecdf(out_dir: str, rmsds, confidences) -> None:
    try:  # ECDF plot of the per-complex best and top-confidence RMSDs; optional, as in the JAX CLI
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 4))
        for label, vals in [("min over poses", rmsds.min(axis=1)),
                            ("top confidence", rmsds[np.arange(len(rmsds)), np.argmax(confidences, axis=1)])]:
            xs = np.sort(vals)
            ax.step(xs, np.arange(1, len(xs) + 1) / len(xs), label=label)
        ax.set_xlabel("RMSD (A)")
        ax.set_ylabel("cumulative fraction")
        ax.set_xlim(0, 10)
        ax.legend()
        fig.tight_layout()
        fig.savefig(f"{out_dir}/rmsd_ecdf.png", dpi=120)
    except Exception as e:
        print(f"ecdf plot skipped: {type(e).__name__}")


if __name__ == "__main__":
    main()
