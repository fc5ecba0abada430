"""DockGen-scale evaluator stress run of the PyTorch port, on the card.

The port's counterpart of ``scripts/stress_eval.py``: drives the port's
``cli.infer`` over 85 synthetic protein-like complexes spread over the
receptor buckets from N=768 to N=3072, with the all-atom confidence rerank
on, at the scale of the reference's DockGen-clusters evaluation (85
complexes). The complexes are the JAX script's, byte for byte
(``write_complex``), and so is the size plan: ``RandomState(0)``, thirds
over 600-1000, 1100-1900 and 2100-2900 residues, ligands of 20-24 atoms.
The models are the full-width score model (``lm_embedding_dim=0``, dropout
0) and the pretrained all-atom confidence architecture (ns=24, nv=6,
sh_lmax=2, crop_beyond 20 A), written as model directories with seeded
random weights. Gates (as the JAX script's): no failure, every complex
evaluated, every ``.npy`` artifact written, the cross-cap telemetry present.

Writes ``docs/artifacts/stress_dockgen_scale_h100.json`` (the JAX
artifact's keys, per-bucket wall stats by the receptor bucket each complex
fell into, plus ``card`` and ``device``); exits 1 when a gate fails.

Usage: python scripts/stress_eval_torch.py [--n 85] [--samples 8] [--steps 20]
       [--device cuda] [--smoke] [--out PATH]
       (--smoke: 3 complexes of 40/90/150 residues, tiny models, 2 poses x 2
       steps on the device given, e.g. ``--smoke --device cpu``)
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

ART = os.path.join(gates_torch.ARTIFACTS, "stress_dockgen_scale_h100.json")
ARTIFACT_FILES = ("rmsds", "centroid_distances", "confidences", "run_times", "complex_names")


def write_complex(root: str, name: str, n_res: int, n_lig: int, seed: int) -> None:
    """A synthetic protein-like complex under ``root/name``: n_res alanine
    residues (N, CA, C) on a 3.8 A random walk confined to a sphere of
    radius 1.3 * 2.2 * n_res^0.38 (the radius-of-gyration scaling), and a
    chain ligand of n_lig carbons near a random residue; the same bytes as
    ``scripts/stress_eval.write_complex``."""
    from confidence_bootstrapping_tpu_torch.data.mol_io import Molecule, write_sdf

    rng = np.random.RandomState(seed)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)

    radius = 1.3 * 2.2 * n_res ** 0.38
    pos = np.zeros((n_res, 3))
    cur = rng.randn(3) * radius / 3
    for i in range(n_res):
        step = rng.randn(3)
        step = 3.8 * step / np.linalg.norm(step)
        nxt = cur + step
        if np.linalg.norm(nxt) > radius:  # reflect back inside
            nxt = cur - step
        pos[i] = cur = nxt

    lines = []
    serial = 1
    for i in range(n_res):
        for aname, elem, off in (("N", "N", [1.4, 0, 0]), ("CA", "C", [0, 0, 0]), ("C", "C", [0, 1.4, 0])):
            x, y, z = pos[i] + off
            lines.append(
                f"ATOM  {serial:5d} {aname:<4s} ALA A{(i % 9999) + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {elem:>2s}"
            )
            serial += 1
    with open(os.path.join(d, f"{name}_protein_processed.pdb"), "w") as f:
        f.write("\n".join(lines) + "\nEND\n")

    center = pos[rng.randint(n_res)]
    lpos = center + np.cumsum(rng.rand(n_lig, 3) * 1.2 + 0.3, axis=0) - n_lig * 0.45
    bonds = [(i, i + 1, 1) for i in range(n_lig - 1)]
    mol = Molecule(np.full(n_lig, 6), lpos, bonds, np.zeros(n_lig, dtype=int), name)
    write_sdf(mol, lpos, os.path.join(d, f"{name}_ligand.sdf"), name=name)


def size_plan(n: int) -> list:
    """(residues, ligand atoms) of each complex: the JAX script's plan,
    ``RandomState(0)`` drawing a size in the thirds (600-1000),
    (1100-1900), (2100-2900) in turn, then each ligand's 20-24 atoms as the
    complexes are written."""
    rng = np.random.RandomState(0)
    sizes = [int(rng.randint(*[(600, 1000), (1100, 1900), (2100, 2900)][i % 3])) for i in range(n)]
    return [(s, int(rng.randint(20, 25))) for s in sizes]


def receptor_bucket(n_res: int) -> int:
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pick_bucket

    return pick_bucket(1, 0, 0, n_res).N


def write_model_dirs(workdir: str, smoke: bool) -> tuple:
    """(score, confidence) model directories holding only a config: the
    CLI draws their weights from seed 0."""
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, save_yaml
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    tiny = dict(ns=8, nv=2, num_conv_layers=1, num_prot_emb_layers=1) if smoke else {}
    conf = dict(tiny) if smoke else dict(ns=24, nv=6, sh_lmax=2, crop_beyond=20.0)
    dirs = []
    for name, cfg in (("score", ScoreModelConfig(lm_embedding_dim=0, dropout=0.0, **tiny)),
                      ("conf", ScoreModelConfig(lm_embedding_dim=0, dropout=0.0, all_atoms=True,
                                                confidence_mode=True, **conf))):
        d = os.path.join(workdir, name)
        os.makedirs(d, exist_ok=True)
        save_yaml(cfg, os.path.join(d, checkpoints.CONFIG_NAME))
        dirs.append(d)
    return tuple(dirs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=85)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None)
    ap.add_argument("--workdir", default=os.path.join(gates_torch.ROOT, "build", "gates", "stress"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    if args.smoke:  # tests/test_stress_eval.py's sizes: three small buckets
        plan, args.samples, args.steps = [(40, 12), (90, 12), (150, 12)], 2, 2
    else:
        plan = size_plan(args.n)
    data_dir = os.path.join(args.workdir, "data")
    t0 = time.time()
    names = []
    for i, (n_res, n_lig) in enumerate(plan):
        names.append(f"stress{i:03d}")
        write_complex(data_dir, names[-1], n_res, n_lig=n_lig, seed=i)
    gen_wall = time.time() - t0
    print(f"generated {len(names)} complexes in {gen_wall:.1f}s", flush=True)
    score_dir, conf_dir = write_model_dirs(args.workdir, args.smoke)

    from confidence_bootstrapping_tpu_torch.cli import infer

    out_dir = os.path.join(args.workdir, "eval")
    t0 = time.time()
    m = infer.main([
        "--data_dir", data_dir, "--out_dir", out_dir,
        "--model_dir", score_dir, "--confidence_model_dir", conf_dir,
        "--samples_per_complex", str(args.samples),
        "--inference_steps", str(args.steps),
        "--batch_size", str(args.samples),
        "--cache_path", os.path.join(args.workdir, "cache"),
        "--device", str(dev),
    ])
    eval_wall = time.time() - t0

    run_times = np.load(os.path.join(out_dir, "run_times.npy"))
    loaded = [str(x) for x in np.load(os.path.join(out_dir, "complex_names.npy"))]
    cold = np.load(os.path.join(out_dir, "cold_variant.npy"))
    size_of = {nm: s for nm, (s, _) in zip(names, plan)}
    per_bucket, per_bucket_warm = {}, {}
    for nm, rt, cd in zip(loaded, run_times, cold):
        b = receptor_bucket(size_of[nm])
        per_bucket.setdefault(b, []).append(float(rt))
        if not cd and rt > 0:
            per_bucket_warm.setdefault(b, []).append(float(rt))

    art = {
        "what": "DockGen-scale evaluator stress run of the PyTorch port: synthetic complexes (the JAX script's "
                "bytes) across the N=768-3072 receptor buckets through cli.infer, all-atom confidence rerank on "
                "(full-size architectures, seeded random weights)" + (" [smoke: tiny models]" if args.smoke else ""),
        "n_complexes": m["n_complexes"],
        "failures": m["failures"],
        "samples_per_complex": args.samples,
        "inference_steps": args.steps,
        "backend": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": gates_torch.card().split(",")[0] if dev.type == "cuda" else "cpu",
        **{k: m.get(k) for k in ("cross_cap_dropped_edge_frac", "cross_cap_overflow_atom_frac",
                                 "cross_cap_dropped_edge_frac_final", "cross_cap_overflow_atom_frac_final",
                                 "cross_cap", "run_times_mean", "run_times_std", "run_times_warm_mean",
                                 "run_times_warm_std", "n_variant_compiles", "wall_breakdown_s")},
        "per_bucket_run_time_mean_s": {str(b): round(float(np.mean(v)), 3) for b, v in sorted(per_bucket.items())},
        "per_bucket_warm_run_time_mean_s": {str(b): round(float(np.mean(v)), 3)
                                            for b, v in sorted(per_bucket_warm.items())},
        "per_bucket_n": {str(b): len(v) for b, v in sorted(per_bucket.items())},
        "eval_wall_s": round(eval_wall, 1),
        "generation_wall_s": round(gen_wall, 1),
        "metric_dict_keys": sorted(m.keys()),
        "poses_per_sec": m.get("poses_per_sec"),
        "poses_per_sec_warm": m.get("poses_per_sec_warm"),
    }
    gates = {
        "no_failures": m["failures"] == 0,
        "every_complex": m["n_complexes"] == len(plan),
        "telemetry": m.get("cross_cap_dropped_edge_frac_final") is not None,
        "artifacts": all(os.path.exists(os.path.join(out_dir, f"{a}.npy")) for a in ARTIFACT_FILES),
    }
    art["gates"] = gates
    gates_torch.write(args.out, gates_torch.stamp(art, dev))
    print(json.dumps(art, indent=2))
    if not all(gates.values()):
        print(f"stress_eval_torch: FAILED gates {[k for k, v in gates.items() if not v]}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
