"""Pose parity of the phased receptor compaction in the PyTorch port, on the card.

The port's counterpart of ``scripts/phase_parity.py``: the full-width score
model (``ScoreModelConfig(lm_embedding_dim=0)``, seeded weights) samples the
1a0q batch (the committed featurization cache) twice from the same poses
and the same generator, once unphased and once with a phase plan (after
step s keep the ``cap`` residues nearest any pose's ligand), and reports
the final poses' largest and mean per-coordinate deviation and both runs'
plain RMSDs to the crystal pose (mean, min, share under 2 A). A cap that
drops in-cutoff residues shows as a deviation above rounding: beside it, the
unphased sample run again from the same poses and generator (the card's
run-to-run floor).

``--plan`` may be given more than once; ``auto`` is the plan
``sampling.derive_phase_plan`` gives 1a0q (the evaluator's default). Each
plan's run carries the JAX script's keys and each arm's kernel launches by
row (the wrappers count on the card only). Writes
``docs/artifacts/phase_parity_h100.json``.

Usage: python scripts/phase_parity_torch.py [--plan 8:256,14:128] [--plan auto]
       [--poses 32] [--steps 20] [--device cuda] [--smoke] [--out PATH]
       (--smoke: ns=8, 2 trunk layers, 2 poses x 4 steps, default plan 1:256,2:128)
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
import gates_torch  # noqa: E402
from crosscap_ab_torch import launches  # noqa: E402

ART = os.path.join(gates_torch.ARTIFACTS, "phase_parity_h100.json")


def parse_plan(text: str) -> list:
    return [(int(x.split(":")[0]), int(x.split(":")[1])) for x in text.split(",") if x]


def rmsd_summary(r: np.ndarray) -> dict:
    return dict(mean=float(r.mean()), min=float(r.min()), lt2=float((r < 2).mean()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--plan", action="append", default=None, help="s:cap,s:cap,... or auto (repeatable)")
    ap.add_argument("--poses", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler import sampling

    plans = args.plan or (["1:256,2:128"] if args.smoke else ["8:256,14:128"])
    cfg = ScoreModelConfig(lm_embedding_dim=0)
    if args.smoke:
        args.poses, args.steps = 2, 4
        cfg = dataclasses.replace(cfg, ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    gates_torch.warm_tables(dev)
    hc, _ = gates_torch.load_1a0q(0)
    padded = pad_complex(hc, pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)),
                         lm_dim=0)
    batch = replicate_complex(padded, args.poses, device=dev)
    model = get_model(cfg, device=dev, seed=0)
    b0 = sampling.randomize_position(batch, torch.Generator(device=dev).manual_seed(3), cfg.sigma.tr_sigma_max)
    base_cfg = SamplerConfig(inference_steps=args.steps)
    L = len(hc.lig_f)
    ref_pos = np.asarray(hc.orig_lig_pos)

    def run(scfg, key):
        counts = {}
        gates_torch.sync(dev)
        t0 = time.time()
        with launches(counts, key):
            final, _ = sampling.sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(4), device=dev)
            gates_torch.sync(dev)
        return final.lig_pos[:, :L].cpu().numpy(), counts[key], round(time.time() - t0, 3)

    p0, base_launches, base_wall = run(base_cfg, "unphased")
    r0 = np.sqrt(((p0 - ref_pos[None]) ** 2).sum(-1).mean(-1))
    # the floor: the unphased sample again (on the card cross_rev's reverse scatter sums with atomics in a
    # run-dependent order, and 20 steps carry that rounding)
    rerun = np.abs(run(base_cfg, "unphased")[0] - p0)
    floor = dict(max_atom_dev=float(rerun.max()), mean_atom_dev=float(rerun.mean()))
    print(f"unphased sample run again: {json.dumps(floor)}", flush=True)
    runs = []
    for text in plans:
        if text == "auto":
            derived = sampling.with_derived_plan(cfg, base_cfg, padded["rec_pos"], padded["rec_mask"])
            plan = list(zip(derived.rec_phase_steps, derived.rec_phase_caps))
        else:
            plan = parse_plan(text)
        phased = dataclasses.replace(base_cfg, rec_phase_steps=tuple(s for s, _ in plan),
                                     rec_phase_caps=tuple(c for _, c in plan))
        p1, phased_launches, phased_wall = run(phased, "phased")
        r1 = np.sqrt(((p1 - ref_pos[None]) ** 2).sum(-1).mean(-1))
        d = np.abs(p1 - p0)
        row = dict(plan=",".join(f"{s}:{c}" for s, c in plan), plan_arg=text, poses=args.poses,
                   max_atom_dev=float(d.max()), mean_atom_dev=float(d.mean()),
                   rmsd_unphased=rmsd_summary(r0), rmsd_phased=rmsd_summary(r1),
                   launches={"unphased": base_launches, "phased": phased_launches},
                   walls_s={"unphased": base_wall, "phased": phased_wall})
        print(json.dumps(row), flush=True)
        runs.append(row)
    artifact = {
        "what": "pose parity of the phased receptor compaction in the PyTorch port: the full-width score model "
                "(lm 0, seeded weights) samples the 1a0q batch from the committed cache twice from the same poses "
                "and generator, unphased and with each plan; the JAX script's keys per plan" +
                (" [smoke: tiny model]" if args.smoke else ""),
        "backend": "gpu" if dev.type == "cuda" else dev.type,
        "steps": args.steps,
        "unphased_rerun_floor": floor,
        "runs": runs,
    }
    gates_torch.write(args.out, gates_torch.stamp(artifact, dev))


if __name__ == "__main__":
    main()
