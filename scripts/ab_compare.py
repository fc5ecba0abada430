"""Time two trees of the repository in turns on one card: phase 5's sample
(``chip_smoke.main_path``: B=32, 20 steps, 1a0q) and phase 6's B=32
confidence forward (``score_confidence`` of poses near the crystal pose), so
that a change's end-to-end numbers can be held against its parent's in one
call.

From the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit, with each tree unpacked by ``git archive``:

    python scripts/ab_compare.py <tree A> <tree B> [--rounds 2] [--runs 5]

Each round runs A, B, B, A, every run in a process of its own from its
tree's root (building that tree's kernels first, then one warm-up and
``--runs`` timed runs of each path, host clock to ``torch.cuda.synchronize``).
Prints one JSON line per run, then the medians and ranges per tree and the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CHILD = """
import json, os, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import confidence_bootstrapping_tpu_torch
from confidence_bootstrapping_tpu_torch.config import confidence_model_config
from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel
from confidence_bootstrapping_tpu_torch.ops.cuda import build
from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

RUNS = int(sys.argv[1])
build.build()
dev = torch.device("cuda")


def timed(fn):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(RUNS):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


_, _, run = cs.main_path(dev)
sample = timed(run)
padded, hc, _ = cs.host_complex(cs.LM_DIM, all_atoms=True)
padded["lig_pos"][: len(hc.orig_lig_pos)] = hc.orig_lig_pos
conf = AllAtomScoreModel(confidence_model_config(lm_embedding_dim=cs.LM_DIM), device=dev, seed=0)
batch = replicate_complex(padded, cs.B_POSES, device=dev)
poses = cs.near_crystal_poses(padded, cs.B_POSES).to(dev)
rerank = timed(lambda: score_confidence(conf, batch, lig_pos=poses))
print("RESULT " + json.dumps({"sample_s": sample, "rerank_s": rerank}), flush=True)
"""


def run_tree(tree: str, runs: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(runs)], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: the timed run failed:\n{out.stderr[-4000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    trees = {"A": os.path.abspath(args.tree_a), "B": os.path.abspath(args.tree_b)}
    times = {k: {"sample_s": [], "rerank_s": []} for k in trees}
    for _ in range(args.rounds):
        for k in ("A", "B", "B", "A"):
            res = run_tree(trees[k], args.runs)
            print(json.dumps({"tree": k, "path": trees[k], **res}), flush=True)
            for m in res:
                times[k][m] += res[m]
    for k, path in trees.items():
        summary = {m: {"median": float(np.median(v)), "min": min(v), "max": max(v), "n": len(v)}
                   for m, v in times[k].items()}
        print(json.dumps({"tree": k, "path": path, "summary": summary}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
