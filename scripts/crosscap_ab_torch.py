"""Cross-edge cap quality A/B of the PyTorch port at DockGen receptor scale, on the card.

The port's counterpart of ``scripts/crosscap_ab.py``, arm for arm. The
score model keeps the nearest ``cross_cap`` receptor residues of each ligand
atom (every in-radius one when the cap is N, the receptor bucket). For
synthetic protein-like receptors in the N=1024/2048/3072 buckets
(``stress_eval_torch.write_complex``: 900/1800/2800 residues, seeds 100+i,
22-atom ligands) and two weight sets of ``ScoreModelConfig(lm_embedding_dim=0,
dropout=0, batch_norm=False, cross_cap_frac=0)`` -- the seeded random
initialisation and the EMA weights after 600 full-sigma steps on 1a0q at
B=16, lr 1e-3 -- it measures:

  A. the forward deviation: tr/rot/tor scores at caps 48, 96, 192 and the
     scaled cap round(N/5) against the uncapped forward (cap = N), at t in
     {1, 0.5, 0.25, 0}: relative L2 and cosine per head over B poses;
  B. the rollout divergence: 20 sampler steps from the same poses with the
     same generator per arm at caps 48, round(N/5) and the largest fixed cap
     below N, and uncapped; per-pose RMSD to the uncapped final poses, beside
     a second uncapped run with another seed (the noise floor) and, on the
     card, one with the same seed (the run-to-run floor of its atomics).

Where it differs from the JAX harness: that one forces one plain XLA route
for every arm (``CBT_DISABLE_FUSED=1``). The port has no such switch: a cap
on the 16-grid (48, 96, 192, and the uncapped N) takes cross_rev (row 3 of
PERF.md's kernel table), a scaled cap off it (205, 410, 614) rows 4 and 6
and a scatter (``models/layers.py``, the K % 16 gate). So the arms also
differ by a route. The artifact records each arm's launches by row, and the
route's own error at N=3072: one t=0 forward at the uncapped cap (K = N =
3072 on cross_rev, checked before the timed arms) and one at the scaled cap,
each kernel call replayed through the kernel and its plain version
(``chip_smoke.record_calls``/``replay``), and the same forwards with every
kernel swapped for its plain version, as relative L2 per head beside the
cap's effect.

Writes ``docs/artifacts/crosscap_ab_h100.json`` (the JAX artifact's keys
plus ``card``, ``device``, ``launches`` and ``route_check``).

Usage: python scripts/crosscap_ab_torch.py [--train_steps 600] [--poses 8]
       [--device cuda] [--smoke] [--out PATH]
       (--smoke: ns=8, 2 trunk layers, 2 steps, 2 poses x 4 steps, caps 8
       and 16 on one 60-residue complex)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import gates_torch  # noqa: E402

ART = os.path.join(gates_torch.ARTIFACTS, "crosscap_ab_h100.json")
T_GRID = (1.0, 0.5, 0.25, 0.0)
SCALED_FRAC = 0.2  # the bucket-scaled candidate, cap = round(N * 0.2) (the cross_cap_frac policy)
IN_RECEPTOR_A = 10.0  # a final pose whose ligand centroid lies farther than this from every residue left the receptor
# the wrappers the score model's conv layers call, by row of PERF.md's kernel table (chip_smoke's counters)
ROWS = {"tpconv_rec": "1", "tpconv_pb": "2", "tpconv_cross_rev": "3", "tpconv_cross": "4", "tpconv_nbr": "5",
        "tpconv_msgs": "6", "tpconv_edge": "7", "tpconv_rec_g": "8", "tpconv_rec_dm": "8 (mask)",
        "tpconv_rec_g_dm": "8 (mask, rec_g)", "tpconv_cross_g": "9", "tpconv_bwd": "10"}
INFERENCE_KERNELS = ("tpconv_rec", "tpconv_pb", "tpconv_cross_rev", "tpconv_cross", "tpconv_nbr", "tpconv_msgs")


def scaled_cap(N: int) -> int:
    return int(round(N * SCALED_FRAC))


def forward_caps(caps, N: int) -> list:
    """Part A's capped arms at bucket N (the uncapped forward is the baseline)."""
    return [c for c in sorted(set(list(caps) + [scaled_cap(N)])) if c < N]


def rollout_caps(caps, N: int) -> list:
    """Part B's capped arms: the first and the largest fixed cap below N and
    the scaled cap (the rollouts are the expensive arm)."""
    below = [c for c in caps if c < N]
    return sorted({below[0], below[-1], scaled_cap(N)}) if below else [scaled_cap(N)]


def rel_stats(a, b) -> tuple:
    """a against the baseline b: relative L2 and cosine over the flattened batch."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    nb = np.linalg.norm(b)
    rel = float(np.linalg.norm(a - b) / max(nb, 1e-12))
    cos = float(a @ b / max(np.linalg.norm(a) * nb, 1e-30))
    return round(rel, 4), round(cos, 4)


def in_receptor(poses, rec_pos) -> dict:
    """Final poses [B, L, 3] against the receptor's residues [N, 3]: the
    distance from each ligand centroid to its nearest residue (A), median
    and max, and the share of poses within IN_RECEPTOR_A."""
    d = np.linalg.norm(poses.mean(1)[:, None, :] - rec_pos[None], axis=-1).min(-1)
    return {"centroid_to_nearest_residue_median": round(float(np.median(d)), 3),
            "centroid_to_nearest_residue_max": round(float(d.max()), 3),
            "share_within_10A": round(float((d <= IN_RECEPTOR_A).mean()), 4)}


def pose_rmsd_rows(poses, base) -> dict:
    rms = np.sqrt(((poses - base) ** 2).sum(-1).mean(-1))  # per pose
    return {"pose_rmsd_vs_uncapped_mean": round(float(rms.mean()), 3),
            "pose_rmsd_vs_uncapped_max": round(float(rms.max()), 3),
            "pose_rmsd_vs_uncapped_median": round(float(np.median(rms)), 3)}


class Arms:
    """The score model of ``cfg`` at any cross cap, with any weights: one
    model a cap on ``dev``, loaded with the weights asked for."""

    def __init__(self, cfg, dev):
        self.cfg, self.dev, self.models, self.loaded = cfg, dev, {}, {}

    def at(self, cap: int, weights: dict):
        from confidence_bootstrapping_tpu_torch.models.factory import get_model

        if cap not in self.models:
            self.models[cap] = get_model(dataclasses.replace(self.cfg, cross_cap=cap), device=self.dev)
        if self.loaded.get(cap) is not weights:
            self.models[cap].load_state_dict(weights)
            self.loaded[cap] = weights
        return self.models[cap]

    def forward(self, weights: dict, batch, cap: int, t: float) -> tuple:
        """(tr, rot, tor) scores of ``batch`` at time t, as numpy."""
        import torch

        with torch.no_grad():
            out = self.at(cap, weights)(batch.set_time(t, t, t))
        return tuple(o.float().cpu().numpy() for o in (out.tr_pred, out.rot_pred, out.tor_pred))


@contextlib.contextmanager
def launches(into: dict, key: str):
    """The kernel launches inside the block, by row (the wrappers count on
    the card only), under ``into[key]``."""
    import chip_smoke

    before = chip_smoke.read_counters()
    try:
        yield
    finally:
        diff = chip_smoke.launch_diff(before, chip_smoke.read_counters())
        into[key] = {f"{ROWS.get(k, k)} {k}": n for k, n in diff.items() if n}


@contextlib.contextmanager
def plain_route():
    """Every inference kernel of the conv layers swapped for its plain version."""
    import chip_smoke
    from confidence_bootstrapping_tpu_torch.models import layers

    kernels = {**chip_smoke.sample_kernels(), **chip_smoke.eval_kernels()}
    real = {name: getattr(layers, "fused_" + name) for name in INFERENCE_KERNELS}
    try:
        for name in INFERENCE_KERNELS:
            setattr(layers, "fused_" + name, (lambda plain: lambda *a, **k: plain(*a))(kernels[name][1]))
        yield
    finally:
        for name, fn in real.items():
            setattr(layers, "fused_" + name, fn)


def route_check(arms: Arms, weights: dict, batch, caps, dev) -> dict:
    """At each cap, one t=0 forward: its kernel calls replayed through kernel
    and plain version (on the card), and the forward on the plain versions
    against the kernels' (relative L2 per head)."""
    import torch

    import chip_smoke

    out = {}
    kernels = {**chip_smoke.sample_kernels(), **chip_smoke.eval_kernels()}
    for cap in caps:
        calls = chip_smoke.record_calls(lambda: arms.forward(weights, batch, cap, 0.0), names=INFERENCE_KERNELS)
        row = {"calls": {k: len(v) for k, v in calls.items() if v}}
        if dev.type == "cuda":
            used = {k: kernels[k] for k in INFERENCE_KERNELS if calls[k]}
            rows = chip_smoke.replay(calls, used, timed=False)
            row["kernel_max_abs_err"] = {r["name"]: r["max_abs_err"] for r in rows}
            row["kernel_tolerance"] = f"{chip_smoke.KERNEL_RTOL} x max(1, max |plain|)"
        else:
            row["kernel_max_abs_err"] = "not measured: the CPU runs the plain versions"
        del calls
        got = arms.forward(weights, batch, cap, 0.0)
        with plain_route():
            ref = arms.forward(weights, batch, cap, 0.0)
        row["forward_rel_l2_kernels_vs_plain"] = {h: float(np.linalg.norm(np.float64(a) - b) /
                                                           max(np.linalg.norm(np.float64(b)), 1e-12))
                                                  for h, a, b in zip(("tr", "rot", "tor"), got, ref)}
        out[f"cap{cap}"] = row
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def train_weights(cfg, model, steps: int, batch_size: int, dev, seed: int = 7) -> dict:
    """``steps`` full-sigma Adam steps (lr 1e-3) of ``model`` on 1a0q
    replicated ``batch_size`` times, from generator ``seed``: {"ema": the EMA
    weights, "last": the weights after the last step, "loss": the loss of
    every step, "skipped": the steps the NaN skip dropped}."""
    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping.finetune import rollout_weights
    from confidence_bootstrapping_tpu_torch.config import TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.train import train_loop

    hc, _ = gates_torch.load_1a0q(0)
    padded = pad_complex(hc, pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)),
                         lm_dim=0)
    tcfg = TrainConfig(lr=1e-3, batch_size=batch_size)
    state = train_loop.init_train_state(model, tcfg)
    step_fn = train_loop.make_train_step(cfg, tcfg)
    tb = replicate_complex(padded, batch_size, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses, skipped = [], []
    for _ in range(steps):
        metrics = step_fn(state, tb, gen)
        losses.append(metrics["loss"].detach())
        skipped.append(metrics["skipped"].detach())
    model.requires_grad_(False)
    ema = rollout_weights(get_model(cfg, device=dev).requires_grad_(False), state, use_ema=True)
    return {"ema": {k: v.clone() for k, v in ema.state_dict().items()},
            "last": {k: v.clone() for k, v in model.state_dict().items()},
            "loss": torch.stack(losses).cpu().tolist() if losses else [],
            "skipped": int(torch.stack(skipped).sum().item()) if skipped else 0}


def synthetic_complexes(sizes, root: str) -> dict:
    """n_res -> the padded synthetic complex (the JAX harness's files)."""
    from confidence_bootstrapping_tpu_torch.data import featurize, mol_io
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket
    from stress_eval_torch import write_complex

    out = {}
    for i, n_res in enumerate(sizes):
        name = f"ab{i}"
        write_complex(root, name, n_res, n_lig=22, seed=100 + i)
        d = os.path.join(root, name)
        hc = featurize.build_host_complex(name, mol_io.read_molecule(os.path.join(d, f"{name}_ligand.sdf")),
                                          mol_io.parse_pdb(os.path.join(d, f"{name}_protein_processed.pdb")))
        out[n_res] = pad_complex(hc, pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src),
                                                 len(hc.rec_f)), lm_dim=0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train_steps", type=int, default=600)
    ap.add_argument("--train_batch", type=int, default=16)
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--inference_steps", type=int, default=20)
    ap.add_argument("--caps", default="48,96,192")
    ap.add_argument("--sizes", default="900,1800,2800")
    ap.add_argument("--device", default=None)
    ap.add_argument("--workdir", default=os.path.join(gates_torch.ROOT, "build", "gates", "crosscap"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler import sampling

    caps = [int(c) for c in args.caps.split(",")]
    sizes = [int(s) for s in args.sizes.split(",")]
    # batch_norm=False: statistics of one replicated complex are degenerate on others, and batch statistics would
    # let the cap move the normalisation between arms; cross_cap_frac=0: every arm pins its exact cap
    cfg = ScoreModelConfig(lm_embedding_dim=0, dropout=0.0, batch_norm=False, cross_cap_frac=0.0)
    if args.smoke:
        args.train_steps, args.poses, args.inference_steps = 2, 2, 4
        caps, sizes = [8, 16], [60]
        cfg = dataclasses.replace(cfg, ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    gates_torch.warm_tables(dev)
    arms = Arms(cfg, dev)
    launch_counts = {}

    complexes = synthetic_complexes(sizes, os.path.join(args.workdir, "data"))
    model = get_model(cfg, device=dev, seed=0)
    random_init = {k: v.clone() for k, v in model.state_dict().items()}

    # the route at the largest receptor before the timed arms: cross_rev at K = N, the scaled cap's rows 4 and 6
    big = replicate_complex(complexes[sizes[-1]], args.poses, device=dev)
    N_big = big.rec_pos.shape[1]
    big = sampling.randomize_position(big, torch.Generator(device=dev).manual_seed(5), cfg.sigma.tr_sigma_max)
    t0 = time.time()
    route = {f"N{N_big}/random_init/{k}": v
             for k, v in route_check(arms, random_init, big, [N_big, scaled_cap(N_big)], dev).items()}
    print(f"route check at N={N_big}: {json.dumps(route)} ({time.time() - t0:.1f}s)", flush=True)

    # ---- semi-trained weights: a full-sigma overfit on 1a0q
    gates_torch.sync(dev)
    t0 = time.time()
    with launches(launch_counts, "train"):
        trained = train_weights(cfg, model, args.train_steps, args.train_batch, dev)
        gates_torch.sync(dev)
    wall_train = time.time() - t0
    print(f"overfit train {args.train_steps} steps: {wall_train:.1f}s final loss "
          f"{trained['loss'][-1] if trained['loss'] else float('nan'):.3f}, {trained['skipped']} steps skipped",
          flush=True)
    weight_sets = {"random_init": random_init, "trained": trained["ema"]}
    del model

    # ---- A: forward deviation
    forward = {}
    t0 = time.time()
    for n_res, padc in complexes.items():
        batch = replicate_complex(padc, args.poses, device=dev)
        N = batch.rec_pos.shape[1]
        b0 = sampling.randomize_position(batch, torch.Generator(device=dev).manual_seed(5), cfg.sigma.tr_sigma_max)
        for wname, weights in weight_sets.items():
            with launches(launch_counts, f"A/N{N}/{wname}/cap{N}"):
                base = {t: arms.forward(weights, b0, N, t) for t in T_GRID}
            for cap in forward_caps(caps, N):
                with launches(launch_counts, f"A/N{N}/{wname}/cap{cap}"):
                    for t in T_GRID:
                        got = arms.forward(weights, b0, cap, t)
                        forward[f"N{N}/{wname}/cap{cap}/t{t}"] = {
                            head: dict(zip(("rel_l2", "cos"), rel_stats(a, b)))
                            for head, a, b in zip(("tr", "rot", "tor"), got, base[t])}
        print(f"forward deviations done for N={N}", flush=True)
    wall_forward = time.time() - t0

    # ---- B: rollout divergence (trained weights, the same generator per arm)
    rollout, rerun_floor, placed = {}, {}, {}
    scfg = SamplerConfig(inference_steps=args.inference_steps)
    t0 = time.time()
    for n_res, padc in complexes.items():
        batch = replicate_complex(padc, args.poses, device=dev)
        N = batch.rec_pos.shape[1]
        b0 = sampling.randomize_position(batch, torch.Generator(device=dev).manual_seed(11), cfg.sigma.tr_sigma_max)
        lm = batch.lig_mask[0].cpu().numpy().astype(bool)

        def roll(cap, seed):
            m = arms.at(cap, weight_sets["trained"])
            with launches(launch_counts, f"B/N{N}/cap{cap}/seed{seed}"):
                fin, _ = sampling.sample(m, b0, m.cfg, scfg, torch.Generator(device=dev).manual_seed(seed),
                                         device=dev)
                gates_torch.sync(dev)
            return fin.lig_pos.cpu().numpy()[:, lm]

        finals = {}
        for cap in rollout_caps(caps, N) + [N]:
            t1 = time.time()
            finals[cap] = roll(cap, 12)
            print(f"rollout N={N} cap={cap}: {time.time() - t1:.1f}s", flush=True)
        base = finals[N]
        rec = batch.rec_pos[0].cpu().numpy()[batch.rec_mask[0].cpu().numpy().astype(bool)]
        placed[f"N{N}/uncapped"] = in_receptor(base, rec)
        # the noise floor: the same uncapped model with another seed (reverse diffusion is chaotic)
        rollout[f"N{N}/key_noise_floor"] = pose_rmsd_rows(roll(N, 13), base)
        # the card's own floor: the uncapped rollout again with the same seed (cross_rev's reverse scatter sums
        # with atomics in a run-dependent order, and 20 steps carry that rounding)
        rerun_floor[f"N{N}/same_seed_rerun"] = pose_rmsd_rows(roll(N, 12), base)
        for cap, poses in finals.items():
            if cap != N:
                rollout[f"N{N}/cap{cap}"] = pose_rmsd_rows(poses, base)
    wall_rollout = time.time() - t0

    # ---- conclusion (the JAX harness's keys)
    def bucket(k):
        return int(k[1:].split("/")[0])

    def cap_of(k):
        return int(k.split("/cap")[1].split("/")[0])

    def worst_final_rel(pred):
        return max((v["tr"]["rel_l2"] for k, v in forward.items()
                    if "/trained/" in k and k.endswith("/t0.0") and pred(k)), default=0.0)

    conclusion = {
        "worst_trained_tr_rel_l2_at_final_step_cap48": worst_final_rel(lambda k: "/cap48/" in k),
        "worst_trained_tr_rel_l2_at_final_step_scaled": worst_final_rel(lambda k: cap_of(k) == scaled_cap(bucket(k))),
        "cap48_rollout_divergence": {k: v for k, v in rollout.items() if k.endswith("/cap48")},
        "scaled_cap_rollout_divergence": {k: v for k, v in rollout.items() if "/cap" in k and not k.endswith("/cap48")
                                          and cap_of(k) == scaled_cap(bucket(k))},
        "rollout_key_noise_floor": {k: v for k, v in rollout.items() if k.endswith("key_noise_floor")},
    }
    conclusion["route_worst_forward_rel_l2_kernels_vs_plain"] = {
        k: max(v["forward_rel_l2_kernels_vs_plain"].values()) for k, v in route.items()}
    conclusion["rollout_same_seed_rerun_floor"] = rerun_floor
    # the rollouts compare caps only where the trained model's uncapped poses stay in the receptor
    comparable = all(v["centroid_to_nearest_residue_median"] <= IN_RECEPTOR_A for v in placed.values())
    conclusion["rollout_in_receptor"] = placed
    conclusion["rollouts_comparable"] = comparable

    artifact = {
        "what": "cross_cap quality A/B of the PyTorch port at DockGen receptor scale: forward score deviation and "
                "full-rollout pose divergence against the uncapped-in-bucket forward (cap = N). No phased "
                "compaction. Unlike the JAX harness (CBT_DISABLE_FUSED=1, one plain XLA route), the port's arms also "
                "differ by a route: caps on the 16-grid and the uncapped N take cross_rev (row 3), the scaled caps "
                "rows 4 and 6 and a scatter (models/layers.py, K % 16); 'launches' gives each arm's launches by row, "
                "'route_check' the route's own error at the largest N (each kernel call replayed against its plain "
                "version; the forward on the plain versions against the kernels'). 'train_loss' is every training "
                "step's loss, 'train_skipped_steps' the steps the NaN skip dropped. " +
                ("The rollouts stay in the receptor (conclusion 'rollout_in_receptor')." if comparable else
                 "ROLLOUT BLOCK NOT COMPARABLE: the trained model's uncapped poses leave the receptor (median ligand "
                 f"centroid more than {IN_RECEPTOR_A} A from every residue, conclusion 'rollout_in_receptor'), so "
                 "'rollout_divergence' and the rollout keys of 'conclusion' measure that model's drift, not the "
                 "cap's effect on a docked pose; the forward deviation stands") +
                (" [smoke: tiny model]" if args.smoke else ""),
        "backend": "gpu" if dev.type == "cuda" else dev.type,
        "poses": args.poses,
        "inference_steps": args.inference_steps,
        "caps": caps,
        "receptor_sizes": sizes,
        "train_steps_for_trained_weights": args.train_steps,
        "train_loss": [round(v, 5) for v in trained["loss"]],
        "train_skipped_steps": trained["skipped"],
        "forward_deviation": forward,
        "rollout_divergence": rollout,
        "conclusion": conclusion,
        "route_check": route,
        "launches": launch_counts,
        "walls_s": {"train": round(wall_train, 1), "forward": round(wall_forward, 1),
                    "rollout": round(wall_rollout, 1)},
    }
    gates_torch.write(args.out, gates_torch.stamp(artifact, dev))
    print(json.dumps(conclusion, indent=2))


if __name__ == "__main__":
    main()
