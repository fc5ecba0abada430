"""The score-model training CLI, on the GPU.

Port of ``confidence_bootstrapping_tpu/cli/train.py`` (the reference's
``train.py``): an epoch loop of training steps (EMA, masked batch norm, the
NaN skip), validation losses, a periodic in-training inference benchmark
(symmetry-corrected RMSD < 2 A rates, reference utils/training.py:292-373)
with early stopping on it, the plateau scheduler, warm-up and layer-wise
unfreezing, and the checkpoint zoo under the JAX CLI's file names:
``best_model``, ``best_ema_model``, ``best_inference_epoch_model``,
``best_ema_inference_epoch_model``, ``best_ema_secondary_epoch_model``,
``epoch{N}_model``, ``last_model``, ``last_ema_model`` (Flax msgpack
bundles), the train-state bundle ``last_state``, ``model_config.yml`` and
``history.pkl``. Either package reads the other's workdir (``--restart_dir``,
``--pretrain_dir``).

Datasets (``--dataset``): ``dir`` trains on ``--data_dir``; ``pdbbind``,
``moad``, ``combined`` and ``generalisation`` build the mixtures of
``data/pdbbind.construct_loader_entries``; ``torsional`` pretrains the
torsion head on the small molecules of ``--torsional_data_dir``
(``data/torsional``, ``TensorProductScoreModel.torsional_forward``);
``--add_bootstrapping_dataset`` mixes in a pickle ``cli.bootstrap_gen``
wrote.

Randomness: data shuffles draw from ``np.random.RandomState(--seed)`` as the
JAX CLI's do, so its batches come in the same order; the noise, dropout and
the benchmark's samples draw from one ``torch.Generator`` on the device,
seeded by ``--seed`` (not the JAX package's numbers). Runs on ``--device``
(default: the GPU; without a card it raises unless ``--device cpu`` is
given).

Example:
  python -m confidence_bootstrapping_tpu_torch.cli.train --data_dir data/ \\
      --workdir workdir/run --n_epochs 100 --batch_size 16
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from .. import yaml_io
from ..bootstrapping.finetune import rollout_weights
from ..config import SamplerConfig, ScoreModelConfig, TrainConfig, from_dict, save_yaml, to_dict
from ..data.complex_graph import pad_complex, pick_bucket, replicate_complex
from ..data.dataset import ComplexDataset, discover_dir
from ..eval import rmsd as rmsd_mod
from ..models.factory import get_model
from ..runtime import resolve_device
from ..sampler import sampling
from ..train import checkpoints, train_loop


def get_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default=None,
                   help="directory of complexes; used for validation (required except --dataset torsional)")
    p.add_argument("--split_train", default=None, help="file with train complex names")
    p.add_argument("--split_val", default=None)
    p.add_argument("--cache_path", default="cache")
    p.add_argument("--dataset", default="dir",
                   choices=["dir", "pdbbind", "moad", "combined", "generalisation", "torsional"])
    p.add_argument("--torsional_data_dir", default=None,
                   help="dir of small-molecule SDFs for --dataset torsional (QM9-style pretraining)")
    p.add_argument("--pdbbind_dir", default=None)
    p.add_argument("--moad_dir", default=None)
    p.add_argument("--moad_splits_pkl", default=None)
    p.add_argument("--cluster_to_ligands_pkl", default=None)
    p.add_argument("--pdbsidechain_dir", default=None)
    p.add_argument("--add_bootstrapping_dataset", default=None,
                   help="pickle of generated complexes (cli.bootstrap_gen) mixed into training")
    p.add_argument("--bootstrapping_temperature", type=float, default=1.0)
    p.add_argument("--workdir", default="workdir/run")
    p.add_argument("--config", default=None, help="yaml overlay for the model config")
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--val_inference_freq", type=int, default=5)
    p.add_argument("--test_sigma_intervals", type=int, default=1,
                   help="bucket validation metrics by N diffusion-time intervals")
    p.add_argument("--inference_secondary_metric", default=None,
                   help="extra inference metric tracked with its own best-EMA checkpoint, e.g. valinf_rmsds_lt5")
    p.add_argument("--save_model_freq", type=int, default=0, help="save an epoch{N}_model snapshot every N epochs")
    p.add_argument("--train_inference_freq", type=int, default=0,
                   help="also run the inference benchmark on train complexes every N epochs (overfit check)")
    p.add_argument("--num_inference_complexes", type=int, default=10)
    p.add_argument("--inference_samples", type=int, default=4)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--inference_earlystop_patience", type=int, default=30)
    p.add_argument("--restart_dir", default=None, help="resume the train state (or the weights) from this dir")
    p.add_argument("--restart_lr", type=float, default=None, help="override the learning rate after a restart")
    p.add_argument("--pretrain_dir", default=None, help="initialize weights only (fresh optimizer and EMA)")
    p.add_argument("--warmup_dur", type=int, default=0, help="linear LR warmup epochs")
    p.add_argument("--lr_start_factor", type=float, default=1e-3)
    p.add_argument("--layer_warmup", type=int, default=0, help="unfreeze one extra conv layer every N epochs")
    p.add_argument("--no_matching", action="store_true",
                   help="train on the input SDF geometry instead of conformer-matched poses")
    p.add_argument("--matching_popsize", type=int, default=20)
    p.add_argument("--matching_maxiter", type=int, default=20)
    p.add_argument("--matching_tries", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true", help="shard batches over all local devices")
    p.add_argument("--wandb", action="store_true", help="log to wandb when the package is available")
    p.add_argument("--project", default="cbt_train")
    p.add_argument("--device", default=None, help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def _matching_kwargs(args):
    """Conformer matching of the training ligands (on unless --no_matching,
    as the reference trains: loader.py:136)."""
    return dict(matching=not args.no_matching, matching_tries=args.matching_tries,
                matching_popsize=args.matching_popsize, matching_maxiter=args.matching_maxiter)


def _names(path):
    return open(path).read().split() if path else None


def inference_benchmark(model, dataset, model_cfg: ScoreModelConfig, n_complexes: int, n_samples: int, steps: int,
                        generator: torch.Generator, device=None) -> dict:
    """The in-training benchmark: per complex of ``dataset`` (the first
    ``n_complexes``), ``n_samples`` poses from a random placement over
    ``steps`` reverse-diffusion steps, the best symmetry-corrected RMSD
    against every ground-truth pose (plain RMSD where the dataset has no
    topology); -> the shares of complexes below 2 and 5 A and the mean."""
    dev = resolve_device(device)
    sampler_cfg = SamplerConfig(inference_steps=steps)
    lm = dataset.lm_dim()
    rmsds = []
    for hc in dataset.complexes[:n_complexes]:
        bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                             n_atoms=0 if hc.atom_f is None else len(hc.atom_f), all_atoms=hc.atom_f is not None)
        batch = replicate_complex(pad_complex(hc, bucket, lm_dim=lm), n_samples, device=dev)
        batch = sampling.randomize_position(batch, generator, model_cfg.sigma.tr_sigma_max)
        final, _ = sampling.sample(model, batch, model_cfg, sampler_cfg, generator, device=dev)
        poses = final.lig_pos[:, : len(hc.lig_f)].cpu().numpy()
        mol = dataset.mols.get(hc.name)
        ref = rmsd_mod.ground_truth_poses(hc)
        if mol is not None:
            r = rmsd_mod.symmetry_rmsd(ref, poses, mol.atomic_nums, mol.bonds)
        else:  # no topology (synthetic datasets): min-over-poses plain RMSD
            refs = ref[None] if ref.ndim == 2 else ref
            r = np.sqrt(((poses[None] - refs[:, None]) ** 2).sum(-1).mean(-1)).min(0)
        rmsds.append(np.asarray(r).min())  # best of N per complex
    rmsds = np.asarray(rmsds)
    return dict(valinf_rmsds_lt2=float(np.mean(rmsds < 2)), valinf_rmsds_lt5=float(np.mean(rmsds < 5)),
                valinf_mean_rmsd=float(rmsds.mean()))


def build_datasets(args, model_cfg: ScoreModelConfig, dev):
    """(train dataset, validation dataset, model config): the config gets
    no_torsion off and no ESM features in torsional mode."""
    torsional_mode = args.dataset == "torsional"
    entries = discover_dir(args.data_dir, _names(args.split_train)) if args.data_dir else []
    if args.limit_complexes:
        entries = entries[: args.limit_complexes]
    if torsional_mode:
        import copy

        from ..data.torsional import TorsionalDataset

        if not args.torsional_data_dir:
            raise SystemExit("--dataset torsional requires --torsional_data_dir")
        train_ds = TorsionalDataset(args.torsional_data_dir, limit=args.limit_complexes, device=dev)
        model_cfg = from_dict(ScoreModelConfig, {**to_dict(model_cfg), "no_torsion": False, "lm_embedding_dim": 0})
        k = max(1, len(train_ds) // 10)  # the last 10% of the molecules validate
        val_ds = copy.copy(train_ds)
        val_ds.complexes = train_ds.complexes[-k:]
        if len(train_ds) > 1:
            train_ds.complexes = train_ds.complexes[:-k]
    elif args.dataset == "dir":
        train_ds = ComplexDataset(entries, cache_dir=args.cache_path, all_atoms=model_cfg.all_atoms, device=dev,
                                  **_matching_kwargs(args))
        train_ds.print_statistics()
    else:
        from ..data.pdbbind import construct_loader_entries

        train_ds = construct_loader_entries(args, all_atoms=model_cfg.all_atoms, device=dev, **_matching_kwargs(args))
        for d in train_ds.datasets:
            if hasattr(d, "print_statistics"):
                d.print_statistics()
    if args.add_bootstrapping_dataset:
        from ..bootstrapping.offline_dataset import BootstrappingDataset
        from ..data.pdbbind import CombinedDataset

        with open(args.add_bootstrapping_dataset, "rb") as f:  # a pickle this repository wrote: unpickling runs code
            kept = pickle.load(f)
        boot = BootstrappingDataset(kept, temperature=args.bootstrapping_temperature, seed=args.seed)
        train_ds = CombinedDataset(train_ds, boot, device=dev)
        print(f"mixed in {len(boot)} bootstrapped complexes")
    if not torsional_mode:
        val_entries = (discover_dir(args.data_dir, _names(args.split_val)) if args.split_val
                       else entries[: max(1, len(entries) // 10)])
        val_ds = ComplexDataset(val_entries, cache_dir=args.cache_path, all_atoms=model_cfg.all_atoms, device=dev,
                                **_matching_kwargs(args))
    return train_ds, val_ds, model_cfg


def restore(args, state, tcfg: TrainConfig):
    """``--restart_dir``: the whole train state from its bundle, else the
    weights of its ``last_model`` (EMA = weights); ``--restart_lr`` then
    sets lr_scale. -> (state, first epoch)."""
    start_epoch = 0
    if args.restart_dir:
        restored, ep = checkpoints.load_train_state(args.restart_dir, state)
        if restored is not None:
            state, start_epoch = restored, ep + 1
            print(f"restored full train state (params+opt+EMA) from {args.restart_dir}, resuming at epoch "
                  f"{start_epoch}")
        elif checkpoints.has_checkpoint(args.restart_dir):
            checkpoints.load_params(os.path.join(args.restart_dir, "last_model.msgpack"), state.model)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    state.ema[n].copy_(p)
            print(f"restarted (weights only) from {args.restart_dir}")
        if args.restart_lr is not None:  # the optimizer's base LR is tcfg.lr; lr_scale multiplies it
            state.lr_scale = args.restart_lr / tcfg.lr
            print(f"restart_lr: effective LR set to {args.restart_lr}")
    return state, start_epoch


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError("--data_parallel needs parallel/mesh, which the port has not yet "
                                  "(ROADMAP.md, Queue 1 item 8)")
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)

    model_cfg = ScoreModelConfig(lm_embedding_dim=0)
    if args.config:
        with open(args.config) as f:
            overlay = yaml_io.load(f.read()) or {}
        model_cfg = from_dict(ScoreModelConfig, {**to_dict(model_cfg), **overlay})
    tcfg = TrainConfig(lr=args.lr, batch_size=args.batch_size)
    torsional_mode = args.dataset == "torsional"
    if not torsional_mode and not args.data_dir:
        raise SystemExit("--data_dir is required (except with --dataset torsional)")
    train_ds, val_ds, model_cfg = build_datasets(args, model_cfg, dev)
    print(f"train {len(train_ds)} complexes, val {len(val_ds)}")

    rng = np.random.RandomState(args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    # the JAX CLI initializes its model on an epoch built from RandomState(0); the datasets' own draws (MOAD
    # clusters, bootstrapping picks) advance with it, so the same call keeps them in step
    train_ds.epoch_batches(args.batch_size, np.random.RandomState(0))
    model = get_model(model_cfg, device=dev)
    if args.pretrain_dir and checkpoints.has_checkpoint(args.pretrain_dir):
        checkpoints.load_params(os.path.join(args.pretrain_dir, "last_model.msgpack"), model)
        print(f"initialized weights from {args.pretrain_dir}")
    state = train_loop.init_train_state(model, tcfg)
    state, start_epoch = restore(args, state, tcfg)

    if torsional_mode:
        train_step = train_loop.make_torsional_train_step(model_cfg, tcfg)
        eval_step = train_loop.make_torsional_eval_step(model_cfg, tcfg)
        args.val_inference_freq = 0  # no pose sampling in torsional pretraining
    else:
        train_step = train_loop.make_train_step(model_cfg, tcfg)
        eval_step = train_loop.make_eval_step(model_cfg, tcfg)
    scheduler = train_loop.PlateauScheduler(patience=30, factor=0.7)
    save_yaml(model_cfg, os.path.join(args.workdir, checkpoints.CONFIG_NAME))
    roll_model = None  # the EMA weights with the model's batch statistics, for the benchmark

    def save(name, ema=False):
        checkpoints.save_params(os.path.join(args.workdir, f"{name}.msgpack"), state.model,
                                params=state.ema if ema else None)

    wandb_run = None
    if args.wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=args.project, config=vars(args))
        except Exception as e:
            print(f"wandb unavailable ({type(e).__name__}); continuing without it")

    best_val, best_inf, bad_epochs = np.inf, -np.inf, 0
    best_secondary = -np.inf
    history = []
    for epoch in range(start_epoch, args.n_epochs):
        t0 = time.time()
        batches = train_ds.epoch_batches(args.batch_size, rng)
        if args.warmup_dur and epoch < args.warmup_dur:
            state.lr_scale = args.lr_start_factor + (1 - args.lr_start_factor) * epoch / args.warmup_dur
        elif args.warmup_dur and epoch == args.warmup_dur:
            state.lr_scale = 1.0
        grad_mask = train_loop.layer_freeze_mask(state.model, epoch // args.layer_warmup) if args.layer_warmup else None
        state, train_metrics = train_loop.train_epoch(train_step, state, batches, generator, grad_mask=grad_mask)
        val_metrics = train_loop.test_epoch(eval_step, state, val_ds.epoch_batches(args.batch_size, rng), generator,
                                            intervals=args.test_sigma_intervals)
        entry = dict(epoch=epoch, train=train_metrics, val=val_metrics, wall=time.time() - t0)

        if args.val_inference_freq and (epoch + 1) % args.val_inference_freq == 0:
            if roll_model is None:
                roll_model = get_model(model_cfg, device=dev)
            rollout_weights(roll_model, state, use_ema=True)
            inf = inference_benchmark(roll_model, val_ds, model_cfg, args.num_inference_complexes,
                                      args.inference_samples, args.inference_steps, generator, dev)
            entry["inference"] = inf
            if (args.train_inference_freq and (epoch + 1) % args.train_inference_freq == 0
                    and hasattr(train_ds, "complexes") and hasattr(train_ds, "mols")):
                # overfit check: the same benchmark on the train complexes
                tinf = inference_benchmark(roll_model, train_ds, model_cfg, args.num_inference_complexes,
                                           args.inference_samples, args.inference_steps, generator, dev)
                entry["train_inference"] = {k.replace("valinf", "traininf"): v for k, v in tinf.items()}
            if inf["valinf_rmsds_lt2"] > best_inf:
                best_inf = inf["valinf_rmsds_lt2"]
                save("best_inference_epoch_model")
                save("best_ema_inference_epoch_model", ema=True)
                bad_epochs = 0
            else:
                bad_epochs += 1
            if args.inference_secondary_metric and args.inference_secondary_metric in inf:
                sv = inf[args.inference_secondary_metric]
                if sv > best_secondary:
                    best_secondary = sv
                    save("best_ema_secondary_epoch_model", ema=True)

        if val_metrics["loss"] < best_val:
            best_val = val_metrics["loss"]
            save("best_model")
            save("best_ema_model", ema=True)
        if args.save_model_freq and (epoch + 1) % args.save_model_freq == 0:
            save(f"epoch{epoch}_model")
        state = scheduler.step(state, val_metrics["loss"])
        save("last_model")
        checkpoints.save_train_state(args.workdir, state, epoch)
        save("last_ema_model", ema=True)
        history.append(entry)
        if wandb_run is not None:
            flat = {f"train_{k}": v for k, v in train_metrics.items()}
            flat.update({f"val_{k}": v for k, v in val_metrics.items()})
            flat.update(entry.get("inference", {}))
            wandb_run.log(flat, step=epoch)
        with open(os.path.join(args.workdir, "history.pkl"), "wb") as f:
            pickle.dump(history, f)
        print(f"epoch {epoch}: train loss {train_metrics['loss']:.4f} val {val_metrics['loss']:.4f} "
              f"({entry['wall']:.1f}s)" + (f" inf<2A {entry['inference']['valinf_rmsds_lt2']:.3f}"
                                           if "inference" in entry else ""))
        if bad_epochs * args.val_inference_freq > args.inference_earlystop_patience:
            print("early stopping on inference metric")
            break
    return state, history


if __name__ == "__main__":
    main()
