"""The Confidence-Bootstrapping loop at real bucket sizes, on the card.

The port's counterpart of ``scripts/cb_scale_run.py``: three epochs of
``bootstrapping/finetune.inference_finetune`` (a rollout round every epoch,
8 samples x 20 steps, the auto phase plans, fine-tune B=16 with
fixed_length 32 and lr 1e-4) over 1a0q (the committed featurization cache,
in its all-atom bucket with ``chip_smoke.receptor_atoms``' seeded atoms:
the repository holds no structure file to featurize) and three synthetic
protein-like complexes of 600-1000 residues (``stress_eval_torch``'s
generator, the N=768/1024 buckets, featurized all-atom), with seeded
1280-d ESM-sized receptor embeddings, the full-width score model and the
pretrained all-atom confidence architecture as the filter (seeded random
weights; the cutoff keeps every pose so that the fine-tune sees real work).
It records per epoch the rollout, RMSD, confidence and fine-tune walls and
the rollout poses/s: the loop's choreography and wall budget, not docking
quality.

Writes ``docs/artifacts/cb_scale_h100.json`` (the keys ``cb_scale_run.py``
writes, plus ``card`` and ``device``); exits 1 unless every epoch ran with
no failed round.

Usage: python scripts/cb_scale_run_torch.py [--epochs 3] [--samples 8] [--steps 20] [--lm 1280]
       [--n_synth 3] [--device cuda] [--smoke] [--out PATH]
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

ART = os.path.join(gates_torch.ARTIFACTS, "cb_scale_h100.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lm", type=int, default=1280)
    ap.add_argument("--n_synth", type=int, default=3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--workdir", default=os.path.join(gates_torch.ROOT, "build", "gates", "cb_scale"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping import finetune as ft
    from confidence_bootstrapping_tpu_torch.config import CBConfig, ScoreModelConfig, confidence_model_config
    from confidence_bootstrapping_tpu_torch.data import featurize, mol_io
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from stress_eval_torch import write_complex

    sizes, tiny, conf_w = (600, 1000), {}, {}
    batch, fixed = 16, 32
    if args.smoke:
        args.epochs, args.samples, args.steps, args.lm, args.n_synth = 2, 2, 3, 8, 1
        sizes, batch, fixed = (40, 90), 2, 4
        tiny = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
        conf_w = dict(ns=8, nv=2, num_conv_layers=2)
    data_dir = os.path.join(args.workdir, "data")
    hc, mol = gates_torch.load_1a0q(args.lm, all_atoms=True, lm_seed=1)
    targets = [ft.CBTarget(hc, mol, lm_dim=args.lm)]
    rng = np.random.RandomState(0)
    for i in range(args.n_synth):
        name = f"cbsyn{i:02d}"
        write_complex(data_dir, name, int(rng.randint(*sizes)), int(rng.randint(20, 25)), seed=i)
        d = os.path.join(data_dir, name)
        m = mol_io.read_molecule(os.path.join(d, f"{name}_ligand.sdf"))
        h = featurize.build_host_complex(name, m, mol_io.parse_pdb(os.path.join(d, f"{name}_protein_processed.pdb")),
                                         all_atoms=True)
        # ESM-sized embeddings, seeded (the pretrained score manifest reads 1280-d, reference score_model.py:98-99)
        h = h._replace(rec_lm=np.random.RandomState(1).randn(len(h.rec_f), args.lm).astype(np.float32))
        targets.append(ft.CBTarget(h, m.remove_hs(), lm_dim=args.lm))
    print("targets:", [(t.name, t.bucket.N, t.bucket.A) for t in targets], flush=True)

    model_cfg = ScoreModelConfig(lm_embedding_dim=args.lm, **tiny)
    model = get_model(model_cfg, device=dev, seed=0)
    cmodel = get_model(confidence_model_config(lm_embedding_dim=args.lm, crop_beyond=20.0, **conf_w), device=dev,
                       seed=1).requires_grad_(False)
    cb = CBConfig(
        n_epochs=args.epochs,
        cb_inference_freq=1,
        initial_iterations=1,
        inference_iterations=1,
        inference_samples=args.samples,
        inference_steps=args.steps,
        confidence_cutoff=-1e8,  # random-init confidence: keep every pose so the fine-tune sees real work
        batch_size=batch,
        fixed_length=fixed,
        lr=1e-4,
    )
    gates_torch.sync(dev)
    t0 = time.time()
    _, history = ft.inference_finetune(model, targets, model_cfg, cb, torch.Generator(device=dev).manual_seed(7),
                                       confidence_fn=ft.confidence_function(cmodel),
                                       workdir=os.path.join(args.workdir, "wd"), device=dev)
    gates_torch.sync(dev)
    total = time.time() - t0

    epochs, failures = [], 0
    for h in history:
        e = {"epoch": h.get("epoch"), "wall": round(h["wall"], 3), "wall_train": round(h["wall_train"], 3),
             "train_loss": (h.get("train") or {}).get("loss")}
        if "inference" in h:
            m = h["inference"]
            failures += m.get("failures", 0)
            e.update(wall_rollout=round(m["wall_rollout"], 3), wall_rmsd=round(m["wall_rmsd"], 3),
                     wall_confidence=round(m["wall_confidence"], 3), n_sampled=m["n_sampled"], n_kept=m["n_kept"],
                     failures=m["failures"])
            if m.get("wall_rollout"):
                e["rollout_poses_per_s"] = round(m["n_sampled"] / m["wall_rollout"], 3)
        epochs.append(e)
    out = {
        "what": "the CB loop of the PyTorch port at real bucket sizes: 1a0q from the committed cache (all-atom "
                "bucket, chip_smoke.receptor_atoms' seeded atoms in place of a featurized structure) and synthetic "
                "protein-like complexes featurized all-atom, seeded 1280-d embeddings, the all-atom confidence "
                "filter, seeded random weights" + (" [smoke: tiny models]" if args.smoke else ""),
        "targets": [(t.name, int(t.bucket.N)) for t in targets],
        "lm_dim": args.lm,
        "samples_per_rollout": args.samples,
        "inference_steps": args.steps,
        "total_wall_s": round(total, 1),
        "epochs": epochs,
    }
    ok = len(history) == args.epochs and failures == 0
    out["ok"] = ok
    gates_torch.write(args.out, gates_torch.stamp(out, dev))
    print(json.dumps(out))
    if not ok:
        print(f"cb_scale_run_torch: FAILED ({len(history)} of {args.epochs} epochs, {failures} failed rounds)",
              flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
