"""End-to-end learns-to-dock proofs of the PyTorch port, on the card.

The port's counterpart of ``tests/test_learns_to_dock.py``: its three
proofs at that file's sizes and seeds (seeds of ``torch.Generator``s here,
so the draws are the port's own), run on the card, with that file's
asserts as gates. The score model is the tests' ns=16/nv=4 one (2 trunk
layers, lm 16, dropout 0, the reduced noise ranges ``SIGMA``), trained on
one toy complex (``synthetic_target``, a copy of
``tests/test_bootstrapping._synthetic_target``) for 500 steps at B=8, lr
3e-3, EMA 0.95, snapshots after 0, 200 and 500 steps:

  (a) overfit: the converged model's sampled poses dock (16 poses x 10
      steps: min RMSD < 2 A, mean < 2.5 A and under half the untrained
      mean) and the untrained model's do not (min > 2.5 A);
  (b) the CB loop (7 epochs, rollouts every 2, 16 samples x 10 steps, the
      oracle filter at 3.5 A, B=8, lr 3e-3, no EMA rollouts) from the
      200-step model improves the rollouts: 4 rounds, the first keeps a
      pose, the last's mean RMSD under 0.9 of the first's, at least as many
      kept, a larger share under 5 A;
  (c) a confidence model (the same widths, confidence mode) trained for 30
      epochs of 4 batches of 16 on 48 rollouts of the 200-step model,
      labelled at their median RMSD, picks better than random: over 6
      held-out batches of 8 rollouts its top-1 mean RMSD is under 0.85 of
      the batches' mean and under the pool's median.

Records each proof's RMSDs, the asserts, and which build each layer's
kernels take at ns=16 (the tensor-core stage or a float32 build). Writes
``docs/artifacts/learns_to_dock_h100.json``; exits 1 when an assert fails
(``--smoke``: a few steps of each proof, no gates).

Usage: python scripts/learns_to_dock_torch.py [--device cuda] [--smoke] [--out PATH]
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

ART = os.path.join(gates_torch.ARTIFACTS, "learns_to_dock_h100.json")


def sigma_params():
    from confidence_bootstrapping_tpu_torch.ops.schedules import SigmaParams

    # reduced noise ranges keep the toy task learnable in a few hundred steps
    return SigmaParams(tr_sigma_min=0.1, tr_sigma_max=3.0, rot_sigma_min=0.06, rot_sigma_max=1.6,
                       tor_sigma_min=0.0314, tor_sigma_max=3.14)


def model_config(**overrides):
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig

    return ScoreModelConfig(ns=16, nv=4, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=16, dropout=0.0,
                            sigma=sigma_params(), **overrides)


def synthetic_target(name="AAAA_1", seed=0, n_lig=8, n_rec=20, all_atoms=False, n_atoms=30):
    """A toy complex: a chain ligand of n_lig carbons with one rotatable
    bond and n_rec receptor residues around it (the JAX tests' complex)."""
    from scipy.spatial import cKDTree

    from confidence_bootstrapping_tpu_torch.bootstrapping.finetune import CBTarget
    from confidence_bootstrapping_tpu_torch.data.complex_graph import HostComplex
    from confidence_bootstrapping_tpu_torch.data.mol_io import Molecule

    rng = np.random.RandomState(seed)
    pos = np.cumsum(rng.randn(n_lig, 3).astype(np.float32), axis=0)  # chain
    bonds = [(i, i + 1, 1) for i in range(n_lig - 1)]
    mol = Molecule(np.full(n_lig, 6), pos, bonds, np.zeros(n_lig, dtype=int))
    src = np.asarray([b[0] for b in bonds] + [b[1] for b in bonds], dtype=np.int32)
    dst = np.asarray([b[1] for b in bonds] + [b[0] for b in bonds], dtype=np.int32)
    attr = np.zeros((len(src), 4), dtype=np.float32)
    attr[:, 0] = 1
    tor_src = np.asarray([2], dtype=np.int32)
    tor_dst = np.asarray([3], dtype=np.int32)
    mask_rotate = np.zeros((1, n_lig), dtype=bool)
    mask_rotate[0, 3:] = True
    rec_pos = rng.randn(n_rec, 3).astype(np.float32) * 5
    k = 4
    _, idx = cKDTree(rec_pos).query(rec_pos, k=k + 1)
    atom_kwargs = {}
    if all_atoms:
        ka = 4
        atom_res = rng.randint(0, n_rec, size=n_atoms).astype(np.int32)
        atom_pos = (rec_pos[atom_res] + rng.randn(n_atoms, 3).astype(np.float32) * 1.5)
        _, aidx = cKDTree(atom_pos).query(atom_pos, k=ka + 1)
        atom_kwargs = dict(
            atom_f=rng.randint(0, 3, size=(n_atoms, 4)).astype(np.int32),
            atom_pos=atom_pos.astype(np.float32),
            atom_nbr=aidx[:, 1:].astype(np.int32),
            atom_nbr_mask=np.ones((n_atoms, ka), dtype=bool),
            atom_res=atom_res,
        )
    hc = HostComplex(
        name=name,
        lig_f=rng.randint(0, 2, size=(n_lig, 16)),
        lig_pos=pos,
        lig_edge_src=src,
        lig_edge_dst=dst,
        lig_edge_attr=attr,
        tor_src=tor_src,
        tor_dst=tor_dst,
        mask_rotate=mask_rotate,
        rec_f=rng.randint(0, 20, size=n_rec).astype(np.int32),
        rec_lm=np.zeros((n_rec, 16), dtype=np.float32),
        rec_pos=rec_pos,
        rec_nbr=idx[:, 1:].astype(np.int32),
        rec_nbr_mask=np.ones((n_rec, k), dtype=bool),
        orig_center=np.zeros(3, dtype=np.float32),
        orig_lig_pos=pos,
        **atom_kwargs,
    )
    return CBTarget(hc, mol, lm_dim=16)


def pretrain(dev, target, steps: int, snaps: tuple) -> tuple:
    """(model, {step: state_dict}): the score model trained on the target at
    B=8 (lr 3e-3, EMA 0.95), its weights and batch statistics after 0 and
    each step count in ``snaps``; and the training wall."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.train import train_loop

    cfg = model_config()
    model = get_model(cfg, device=dev, seed=0)
    batch8 = replicate_complex(target.padded, 8, device=dev)
    tcfg = TrainConfig(lr=3e-3, batch_size=8, ema_rate=0.95)
    state = train_loop.init_train_state(model, tcfg)
    step_fn = train_loop.make_train_step(cfg, tcfg)
    gen = torch.Generator(device=dev).manual_seed(42)
    copy = lambda: {k: v.detach().clone() for k, v in model.state_dict().items()}
    snapshots, losses = {0: copy()}, {}
    t0 = time.time()
    for i in range(steps):
        m = step_fn(state, batch8, gen)
        if i + 1 in snaps:
            snapshots[i + 1] = copy()
            losses[i + 1] = round(float(m["loss"]), 4)
    gates_torch.sync(dev)
    return model, snapshots, losses, time.time() - t0


def model_at(dev, state_dict):
    """The toy score model with a snapshot's weights and batch statistics."""
    from confidence_bootstrapping_tpu_torch.models.factory import get_model

    m = get_model(model_config(), device=dev)
    m.load_state_dict(state_dict)
    return m.requires_grad_(False)


def sample_rmsds(model, target, gen, dev, n=16, steps=10) -> np.ndarray:
    """n sampled poses' plain RMSDs to the crystal pose (placement and
    sampler noise from ``gen``)."""
    from confidence_bootstrapping_tpu_torch.config import SamplerConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.sampler import sampling

    cfg = model.cfg
    b0 = sampling.randomize_position(replicate_complex(target.padded, n, device=dev), gen, cfg.sigma.tr_sigma_max)
    final, _ = sampling.sample(model, b0, cfg, SamplerConfig(inference_steps=steps), gen, device=dev)
    L = len(target.hc.lig_f)
    poses = final.lig_pos[:, :L].cpu().numpy()
    return np.sqrt(((poses - np.asarray(target.hc.orig_lig_pos)[None]) ** 2).sum(-1).mean(-1))


def layer_build_lines(model, dev, target) -> dict:
    """Which build each kernel call of one B=8 training step and one
    sample's takes at ns=16: {kernel: {build: calls}} (``chip_smoke``'s
    ``edge_builds`` and ``bwd_builds``), and the inference kernels' builds
    per layer (``tpconv_rec.rec_build`` for rec; pb and cross_rev run
    the tensor-core stage only)."""
    import torch

    import chip_smoke
    from confidence_bootstrapping_tpu_torch.config import TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_rec
    from confidence_bootstrapping_tpu_torch.train import train_loop

    if dev.type != "cuda":
        return {"note": "no kernel runs on the CPU"}
    m = get_model(model.cfg, device=dev)
    m.load_state_dict(model.state_dict())
    tcfg = TrainConfig(lr=3e-3, batch_size=8, ema_rate=0.95)
    state, step_fn = train_loop.init_train_state(m, tcfg), train_loop.make_train_step(m.cfg, tcfg)
    batch = replicate_complex(target.padded, 8, device=dev)
    calls = chip_smoke.record_train_calls(lambda: step_fn(state, batch, torch.Generator(device=dev).manual_seed(0)))
    out = {"training step": {k: v for k, v in chip_smoke.edge_builds(calls).items()},
           "edge backward": chip_smoke.bwd_builds(calls)}
    lines = []
    for name, mod in model.named_modules():
        if isinstance(mod, TPConv) and mod.route == "ladder" and mod.n_edge_features == 3 * model.cfg.ns:
            tc, cm = tpconv_rec.rec_build(mod.in_irreps, mod.out_irreps, model.cfg.ns, model.cfg.ns, mod.hidden, False)
            lines.append(f"{name}: route ladder, rec inference {'tensor cores' if tc else f'float32 at {cm}'}")
        elif isinstance(mod, TPConv):
            lines.append(f"{name}: route {mod.route}")
    out["layers"] = lines
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping import finetune
    from confidence_bootstrapping_tpu_torch.config import CBConfig, SamplerConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.confidence import dataset as cdataset
    from confidence_bootstrapping_tpu_torch.confidence import train as ctrain
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler import sampling

    S = dict(steps=500, snaps=(200, 500), n=16, cb_epochs=7, cb_samples=16, conf_samples=48, conf_epochs=30,
             conf_batches=4, reps=6)
    if args.smoke:
        S = dict(steps=2, snaps=(1, 2), n=2, cb_epochs=3, cb_samples=2, conf_samples=4, conf_epochs=1,
                 conf_batches=1, reps=1)
    partial, full = S["snaps"]
    target = synthetic_target("AAAA_1", 0)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    art = {"what": "the learns-to-dock proofs of tests/test_learns_to_dock.py on the PyTorch port (their sizes; "
                   "torch.Generator seeds in place of the JAX keys), their asserts as gates"
                   + (" [smoke: a few steps]" if args.smoke else ""),
           "backend": "gpu" if dev.type == "cuda" else dev.type, "train_steps": S["steps"],
           "snapshots": [0, partial, full]}
    checks = {}

    model, snaps, losses, wall = pretrain(dev, target, S["steps"], S["snaps"])
    art["pretrain"] = {"loss_at_snapshot": losses, "wall_s": round(wall, 1)}
    art["builds_at_ns16"] = layer_build_lines(model, dev, target)

    # (a) overfit until sampled poses dock
    r_init = sample_rmsds(model_at(dev, snaps[0]), target, gen(100), dev, n=S["n"])
    r_final = sample_rmsds(model_at(dev, snaps[full]), target, gen(100), dev, n=S["n"])
    art["overfit"] = {"untrained": r_init.round(4).tolist(), "trained": r_final.round(4).tolist()}
    checks["overfit"] = {"untrained min > 2.5": bool(r_init.min() > 2.5), "trained min < 2.0": bool(r_final.min() < 2.0),
                         "trained mean < 2.5": bool(r_final.mean() < 2.5),
                         "trained mean < 0.5 untrained mean": bool(r_final.mean() < 0.5 * r_init.mean())}
    print("overfit:", r_init.min(), r_init.mean(), r_final.min(), r_final.mean(), flush=True)

    # (b) the CB loop improves the rollouts of the partially trained model
    cb = CBConfig(n_epochs=S["cb_epochs"], cb_inference_freq=2, inference_samples=S["cb_samples"], inference_steps=10,
                  initial_iterations=1, inference_iterations=1, confidence_cutoff=-3.5, oracle_confidence=True,
                  batch_size=8, lr=3e-3, max_complexes_per_couple=None, use_ema_for_rollouts=False)
    t0 = time.time()
    m200 = model_at(dev, snaps[partial]).requires_grad_(True)
    _, history = finetune.inference_finetune(m200, [target], m200.cfg, cb, gen(7), device=dev)
    inf = [h["inference"] for h in history if "inference" in h]
    art["cb"] = {"rounds": [{k: m[k] for k in ("mean_rmsd", "rmsds_lt2", "rmsds_lt5", "n_kept", "n_sampled")}
                            for m in inf], "wall_s": round(time.time() - t0, 1)}
    checks["cb"] = {"4 rounds": len(inf) == 4, "first round keeps a pose": inf[0]["n_kept"] > 0,
                    "last mean RMSD < 0.9 first": inf[-1]["mean_rmsd"] < 0.9 * inf[0]["mean_rmsd"],
                    "last kept >= first kept": inf[-1]["n_kept"] >= inf[0]["n_kept"],
                    "last share < 5 A > first": inf[-1]["rmsds_lt5"] > inf[0]["rmsds_lt5"]}
    print("cb:", art["cb"]["rounds"], flush=True)

    # (c) a confidence model trained on generated poses lifts top-1
    t0 = time.time()
    m200 = model_at(dev, snaps[partial])
    cache = cdataset.generate_filtering_cache(m200, [target], gen(11), m200.cfg, samples_per_complex=S["conf_samples"],
                                              inference_steps=10, device=dev)
    cutoff = float(np.median(cache[target.name][1]))
    conf_model = get_model(model_config(confidence_mode=True), device=dev, seed=12)
    ds = cdataset.FilteringDataset([target], cache, rmsd_classification_cutoff=cutoff, rmsd_classification_upper=None,
                                   balance=False, seed=3, device=dev)
    ctrain.train_confidence(conf_model, ds, cache, TrainConfig(lr=3e-3, batch_size=16), n_epochs=S["conf_epochs"],
                            batches_per_epoch=S["conf_batches"], generator=gen(13), log=lambda s: None)
    conf_model.requires_grad_(False)
    g = gen(500)
    top1, rand, pool = [], [], []
    L = len(target.hc.lig_f)
    for _ in range(S["reps"]):
        b0 = sampling.randomize_position(replicate_complex(target.padded, 8, device=dev), g, m200.cfg.sigma.tr_sigma_max)
        final, _ = sampling.sample(m200, b0, m200.cfg, SamplerConfig(inference_steps=10), g, device=dev)
        poses = final.lig_pos[:, :L]
        r = np.sqrt(((poses.cpu().numpy() - np.asarray(target.hc.orig_lig_pos)[None]) ** 2).sum(-1).mean(-1))
        conf = sampling.score_confidence(conf_model, replicate_complex(target.padded, 8, device=dev), lig_pos=final.lig_pos)
        top1.append(float(r[int(torch.argmax(conf))]))
        rand.append(float(r.mean()))
        pool.extend(r.tolist())
    t1, rnd = float(np.mean(top1)), float(np.mean(rand))
    art["rerank"] = {"cutoff": round(cutoff, 4), "top1_trained": round(t1, 4), "random": round(rnd, 4),
                     "pool_min": round(float(np.min(pool)), 4), "pool_median": round(float(np.median(pool)), 4),
                     "top1_per_batch": [round(v, 4) for v in top1], "wall_s": round(time.time() - t0, 1)}
    checks["rerank"] = {"0.5 < cutoff < 10": 0.5 < cutoff < 10.0, "top1 < 0.85 random": t1 < 0.85 * rnd,
                        "top1 < pool median": t1 < float(np.median(pool))}
    print("rerank:", art["rerank"], flush=True)

    art["asserts"] = checks
    ok = all(v for c in checks.values() for v in c.values())
    if not args.smoke:
        art["ok"] = ok
    gates_torch.write(args.out, gates_torch.stamp(art, dev))
    print(json.dumps({"ok": ok, "asserts": checks}))
    if not args.smoke and not ok:
        print("learns_to_dock_torch: FAILED", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
