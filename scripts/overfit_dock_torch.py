"""Full-sigma learns-to-dock on the featurized 1a0q, on the card.

The port's counterpart of ``scripts/overfit_dock_tpu.py``: train the
full-width score model (the pretrained manifest's architecture,
``lm_embedding_dim=0``, dropout 0 so that the one-complex overfit is not
regularized away) on 1a0q (the committed featurization cache) at the
production noise range (tr_sigma_max 19 A), 1500 Adam steps at B=32 and lr
1e-3 through the port's training step (``train/train_loop``: the edge-list
forward, rec with the dropout mask and the edge backward, rows 7, 8, 10-12
of PERF.md's kernel table), then sample 32 poses x 20 steps with the phase
plan ``derive_phase_plan`` gives 1a0q and record the plain RMSDs to the
crystal pose for the untrained, trained and EMA parameters. The weights are
seeded (seed 0), the training noise and the sampler draw from seeded
generators on the device.

Gates (the JAX script's): untrained min RMSD > 10 A; min(trained, EMA) min
RMSD < 5 A. Writes ``docs/artifacts/overfit_dock_h100.json``; exits 1 when
a gate fails (``--smoke``: a tiny model, 3 steps, no gates).

Usage: python scripts/overfit_dock_torch.py [--steps 1500] [--batch 32] [--poses 32]
       [--device cuda] [--smoke] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import gates_torch  # noqa: E402

ART = os.path.join(gates_torch.ARTIFACTS, "overfit_dock_h100.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--poses", type=int, default=32)
    ap.add_argument("--inference_steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping.finetune import rollout_weights
    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler import sampling
    from confidence_bootstrapping_tpu_torch.train import train_loop

    hc, _ = gates_torch.load_1a0q(0)
    padded = pad_complex(hc, pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)),
                         lm_dim=0)
    if args.smoke:
        cfg = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0, dropout=0.0)
        args.steps, args.batch, args.poses = 3, 2, 2
    else:
        cfg = ScoreModelConfig(lm_embedding_dim=0, dropout=0.0)
    model = get_model(cfg, device=dev, seed=0)
    train_batch = replicate_complex(padded, args.batch, device=dev)

    # the production sampler path: the auto-derived phase plan (cli.infer's and the CB rollouts' default)
    scfg = sampling.with_derived_plan(cfg, SamplerConfig(inference_steps=args.inference_steps), padded["rec_pos"],
                                      padded["rec_mask"])
    plan = [list(p) for p in zip(scfg.rec_phase_steps or (), scfg.rec_phase_caps or ())]
    print(f"phase plan: {plan}", flush=True)
    L = len(hc.lig_f)
    truth = np.asarray(hc.orig_lig_pos)

    def sample_rmsds(m, seed):
        b0 = sampling.randomize_position(replicate_complex(padded, args.poses, device=dev),
                                         torch.Generator(device=dev).manual_seed(seed), cfg.sigma.tr_sigma_max)
        final, _ = sampling.sample(m, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
        poses = final.lig_pos[:, :L].cpu().numpy()
        return np.sqrt(((poses - truth[None]) ** 2).sum(-1).mean(-1))

    t0 = time.time()
    rows = {"untrained": gates_torch.rmsd_rows(sample_rmsds(model, 100))}
    wall_sample = time.time() - t0
    print("untrained", rows["untrained"], flush=True)

    tcfg = TrainConfig(lr=args.lr, batch_size=args.batch)
    state = train_loop.init_train_state(model, tcfg)
    step_fn = train_loop.make_train_step(cfg, tcfg)
    gen = torch.Generator(device=dev).manual_seed(42)
    losses = []
    gates_torch.sync(dev)
    t0 = time.time()
    for i in range(args.steps):
        metrics = step_fn(state, train_batch, gen)
        if i % 100 == 0 or i == args.steps - 1:
            row = {"step": i, "loss": round(float(metrics["loss"]), 4), "tr": round(float(metrics["tr_loss"]), 4),
                   "rot": round(float(metrics["rot_loss"]), 4), "tor": round(float(metrics["tor_loss"]), 4),
                   "skipped": int(float(metrics["skipped"]))}
            losses.append(row)
            print(f"{row} ({time.time() - t0:.1f}s)", flush=True)
    gates_torch.sync(dev)
    wall_train = time.time() - t0

    model.requires_grad_(False)
    ema_model = rollout_weights(get_model(cfg, device=dev).requires_grad_(False), state, use_ema=True)
    t0 = time.time()
    for tag, m in (("trained", model), ("ema", ema_model)):
        rows[tag] = gates_torch.rmsd_rows(sample_rmsds(m, 100))
        print(tag, rows[tag], flush=True)
    wall_sample += time.time() - t0

    out = {
        "what": "full-sigma learns-to-dock of the PyTorch port on the featurized 1a0q from the committed cache "
                "(production architecture, tr_sigma_max 19 A, the port's training step and kernels, production "
                "auto phase plan in the sampler; seeded weights and noise)" + (" [smoke: tiny model]" if args.smoke
                                                                               else ""),
        "backend": "gpu" if dev.type == "cuda" else dev.type,
        "train_steps": args.steps,
        "train_batch": args.batch,
        "lr": args.lr,
        "poses": args.poses,
        "inference_steps": args.inference_steps,
        "phase_plan": plan,
        "wall_train_s": round(wall_train, 1),
        "train_step_ms": round(1000 * wall_train / max(args.steps, 1), 1),
        "wall_sample_s": round(wall_sample, 1),
        "loss_trajectory": losses,
        "rmsd": rows,
    }
    gates = {"untrained_min_gt_10": rows["untrained"]["min"] > 10.0,
             "trained_or_ema_min_lt_5": min(rows["trained"]["min"], rows["ema"]["min"]) < 5.0}
    if not args.smoke:
        out["gates"] = gates
    gates_torch.write(args.out, gates_torch.stamp(out, dev))
    print(json.dumps(out))
    if not args.smoke and not all(gates.values()):
        print(f"overfit_dock_torch: FAILED gates {[k for k, v in gates.items() if not v]}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
