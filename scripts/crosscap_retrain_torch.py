"""A second training of the cross-cap A/B's model, against the harness's own.

``scripts/crosscap_ab_torch.py`` trains its "trained" weight set with 600
full-sigma steps on 1a0q from generator seed 7 and records every step's
loss in its artifact. This script trains the same model again, from the
same seeded initialisation and generator seed, on the same card, and shows
how far two such trainings part and what the weights they land on do:

  * the first step at which the two runs' losses differ by a relative 1e-6,
    1e-4, 1e-2 and 1e-1 (the artifact keeps 5 decimals, so at 1e-6 its
    rounding shows too), each run's loss in 50-step means and maxima, and
    the steps the NaN skip dropped in each;
  * 20-step rollouts (8 poses, prior seed 11, sampler seed 12, uncapped) of
    the random initialisation, the new EMA weights and the new last weights
    on the harness's synthetic receptors at N=1024 and N=3072: the ligand
    centroid's distance to the nearest residue (``crosscap_ab_torch.in_receptor``);
  * the same rollouts on 1a0q, the complex the model trained on: RMSD to
    the crystal pose, median and min.

Prints its readings. Run it on the card after the harness, in the same
call (the two trainings are compared on one card):

    python scripts/crosscap_ab_torch.py --out chiprun_out/crosscap_ab_h100.json
    python scripts/crosscap_retrain_torch.py --artifact chiprun_out/crosscap_ab_h100.json

Usage: python scripts/crosscap_retrain_torch.py [--artifact PATH] [--device cuda] [--smoke]
       (--smoke: the harness's tiny model, 2 steps of B=16, 2 poses x 4 steps on one 60-residue complex)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import crosscap_ab_torch as cc  # noqa: E402
import gates_torch  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", default=cc.ART, help="the harness's artifact, with its 'train_loss'")
    ap.add_argument("--device", default=None)
    ap.add_argument("--workdir", default=os.path.join(gates_torch.ROOT, "build", "gates", "crosscap"))
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler import sampling

    with open(args.artifact) as f:
        art = json.load(f)
    cfg = ScoreModelConfig(lm_embedding_dim=0, dropout=0.0, batch_norm=False, cross_cap_frac=0.0)
    steps, sizes, train_batch, poses, inference_steps = 600, [900, 2800], 16, 8, 20
    if args.smoke:
        cfg = dataclasses.replace(cfg, ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
        steps, sizes, poses, inference_steps = 2, [60], 2, 4  # the harness keeps its batch of 16 there too
    gates_torch.warm_tables(dev)
    model = get_model(cfg, device=dev, seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.time()
    tr = cc.train_weights(cfg, model, steps, train_batch, dev)
    out = {"wall_s": round(time.time() - t0, 1), "skipped": tr["skipped"],
           "harness_skipped": art["train_skipped_steps"]}
    print(f"second training {out['wall_s']} s, skipped {tr['skipped']} (harness: {art['train_skipped_steps']})")
    a, b = np.array(art["train_loss"])[:steps], np.array(tr["loss"])
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
    out["first_step_apart"] = {th: int(np.argmax(rel > th)) if (rel > th).any() else None
                               for th in (1e-6, 1e-4, 1e-2, 1e-1)}
    print(f"first step the runs' losses part by rel > 1e-6/1e-4/1e-2/1e-1: {list(out['first_step_apart'].values())}")
    w = min(50, steps)
    for what, x in (("harness", a), ("second", b)):
        out[f"loss_means_{what}"] = np.round(x[: len(x) // w * w].reshape(-1, w).mean(1), 4).tolist()
        out[f"loss_max_{what}"] = np.round(x[: len(x) // w * w].reshape(-1, w).max(1), 4).tolist()
        print(f"{w}-step means {what}: {out[f'loss_means_{what}']}; maxima {out[f'loss_max_{what}']}")

    def roll(arms, weights, b0, N):
        m = arms.at(N, weights)
        fin, _ = sampling.sample(m, b0, m.cfg, SamplerConfig(inference_steps=inference_steps),
                                 torch.Generator(device=dev).manual_seed(12), device=dev)
        return fin.lig_pos.cpu().numpy()

    arms = cc.Arms(cfg, dev)
    weight_sets = (("init", init), ("ema", tr["ema"]), ("last", tr["last"]))
    for padc in cc.synthetic_complexes(sizes, os.path.join(args.workdir, "data")).values():
        batch = replicate_complex(padc, poses, device=dev)
        N = batch.rec_pos.shape[1]
        rec = batch.rec_pos[0].cpu().numpy()[batch.rec_mask[0].cpu().numpy().astype(bool)]
        b0 = sampling.randomize_position(batch, torch.Generator(device=dev).manual_seed(11), cfg.sigma.tr_sigma_max)
        lm = batch.lig_mask[0].cpu().numpy().astype(bool)
        for name, weights in weight_sets:
            out[f"N{N}/{name}"] = cc.in_receptor(roll(arms, weights, b0, N)[:, lm], rec)
            print(f"N={N} {name}: {out[f'N{N}/{name}']}", flush=True)
    # the complex the model trained on
    hc, _ = gates_torch.load_1a0q(0)
    padded = pad_complex(hc, pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)),
                         lm_dim=0)
    batch = replicate_complex(padded, poses, device=dev)
    N, L = batch.rec_pos.shape[1], len(hc.lig_f)
    b0 = sampling.randomize_position(batch, torch.Generator(device=dev).manual_seed(11), cfg.sigma.tr_sigma_max)
    for name, weights in weight_sets:
        rmsd = np.sqrt(((roll(arms, weights, b0, N)[:, :L] - hc.orig_lig_pos[None]) ** 2).sum(-1).mean(-1))
        out[f"1a0q/{name}"] = {"rmsd_median": round(float(np.median(rmsd)), 3), "rmsd_min": round(float(rmsd.min()), 3)}
        print(f"1a0q N={N} {name}: RMSD to the crystal pose median {np.median(rmsd):.3f} min {rmsd.min():.3f}",
              flush=True)
    print(f"card: {gates_torch.card()}")
    return out


if __name__ == "__main__":
    main()
