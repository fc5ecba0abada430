"""ESM-sized (1280-d) sampling at the largest receptor bucket, on the card.

The port's counterpart of ``scripts/esm_scale_check.py``: both pretrained
manifests read 1280-d ESM receptor embeddings (reference
models/score_model.py:98-99), so this samples a synthetic complex of 2800
residues (``stress_eval_torch.write_complex``, seed 0; the N=3072 bucket)
with seeded 1280-d embeddings through the port's full-width score model
(seeded random weights), 8 poses x 20 steps with the phase plan
``derive_phase_plan`` gives it: one warm-up, then the fastest of three
timed samples (host clock, synchronized), poses/s and the device memory
high-water mark (``torch.cuda.max_memory_allocated``).

Writes ``docs/artifacts/esm_scale_h100.json`` (the JAX artifact's keys plus
``card``, ``device`` and the memory); exits 1 unless the poses come back
finite.

Usage: python scripts/esm_scale_check_torch.py [--n_res 2800] [--poses 8] [--steps 20]
       [--lm 1280] [--device cuda] [--smoke] [--out PATH]
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

ART = os.path.join(gates_torch.ARTIFACTS, "esm_scale_h100.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n_res", type=int, default=2800)
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lm", type=int, default=1280)
    ap.add_argument("--device", default=None)
    ap.add_argument("--workdir", default=os.path.join(gates_torch.ROOT, "build", "gates", "esm_scale"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data import featurize, mol_io
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler import sampling
    from stress_eval_torch import write_complex

    tiny = {}
    if args.smoke:
        args.n_res, args.poses, args.steps, args.lm = 150, 2, 8, 16
        tiny = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    write_complex(args.workdir, "esmchk", args.n_res, n_lig=22, seed=0)
    d = os.path.join(args.workdir, "esmchk")
    mol = mol_io.read_molecule(os.path.join(d, "esmchk_ligand.sdf"))
    st = mol_io.parse_pdb(os.path.join(d, "esmchk_protein_processed.pdb"))
    hc = featurize.build_host_complex("esmchk", mol, st)
    hc = hc._replace(rec_lm=np.random.RandomState(0).randn(len(hc.rec_f), args.lm).astype(np.float32))
    bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))
    batch = replicate_complex(pad_complex(hc, bucket, lm_dim=args.lm), args.poses, device=dev)
    N = batch.rec_pos.shape[1]
    print(f"bucket N={N}, rec_lm {tuple(batch.rec_lm.shape)}", flush=True)

    cfg = ScoreModelConfig(lm_embedding_dim=args.lm, **tiny)
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    scfg = sampling.with_derived_plan(cfg, SamplerConfig(inference_steps=args.steps), batch.rec_pos[0].cpu().numpy(),
                                      batch.rec_mask[0].cpu().numpy())
    plan = [list(p) for p in zip(scfg.rec_phase_steps or (), scfg.rec_phase_caps or ())]
    print(f"phase plan: {plan}", flush=True)

    b0 = sampling.randomize_position(batch, torch.Generator(device=dev).manual_seed(1), cfg.sigma.tr_sigma_max)

    def run(seed):
        final, _ = sampling.sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        gates_torch.sync(dev)
        return final.lig_pos

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run(2)  # warm-up
    times, finite = [], True
    for i in range(3):
        t0 = time.perf_counter()
        pos = run(3 + i)
        times.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(pos).all())
    dt = min(times)
    out = {
        "what": "ESM-sized (1280-d, seeded) sampling of the PyTorch port at the largest receptor bucket: memory "
                "+ poses/s (manifests require 1280-d, reference models/score_model.py:98-99); full-width score "
                "model, seeded random weights" + (" [smoke: tiny model]" if args.smoke else ""),
        "backend": "gpu" if dev.type == "cuda" else dev.type,
        "n_res": args.n_res,
        "bucket_N": int(N),
        "lm_dim": args.lm,
        "poses": args.poses,
        "steps": args.steps,
        "phase_plan": plan,
        "sample_wall_s": round(dt, 4),
        "sample_walls_s": [round(t, 4) for t in times],
        "poses_per_s": round(args.poses / dt, 3),
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else None,
        "finite": finite,
    }
    gates_torch.write(args.out, gates_torch.stamp(out, dev))
    print(json.dumps(out))
    if not finite:
        print("esm_scale_check_torch: FAILED: non-finite poses", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
