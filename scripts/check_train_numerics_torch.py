"""Numerics of the port's training path on the card: two well-conditioned checks.

The port's counterpart of ``scripts/check_train_numerics.py`` (whose
docstring explains why a full-model gradient direction at random init is
no criterion):

  A. **Per-op backward parity** at the production irreps specs (the CG
     trunk at lmax=1 with a dropout mask, the torsion head, the all-atom
     trunk at lmax=2; M=1024 edge lists of K=16, H=128, the JAX script's
     seeded inputs): the port's differentiable edge op
     (``ops/cuda/tpconv_train.fused_tpconv_train``: the edge-list kernel
     forward, the edge backward kernel) on the card against the same op on
     the CPU, where every wrapper runs its plain version. Gate: the
     training-op tolerance of ``chip_smoke.py`` phase 7 (the output and the
     per-edge gradients within 2e-4, the weight gradients, sums over every
     edge, within 1e-3, each times max(1, max |plain|); edges with a hidden
     pre-activation within rounding of the ReLU left out of both sides).
     The JAX script's cosine and norm ratio per tensor are reported beside.

  B. **Training-trajectory equivalence**: 150 Adam steps (lr 1e-3) of the
     full-width CG score model (dropout 0.1) on 1a0q at B=16 (``--batch``:
     halved, for both arms, where the CPU arm would run far past 20
     minutes; the artifact records the halvings), the kernel arm
     on the card and the plain arm on the CPU, from the same initial
     weights. Every random number (the diffusion times and noise, the
     dropout masks) is drawn from a CPU ``torch.Generator`` seeded alike in
     each arm and moved to the arm's device, so both arms see the same
     draws. The eval loss (batch statistics, no dropout) averaged over 8
     fixed draws every 5 steps is the descent signal. Gates (the JAX
     script's): each arm's mean-draw eval loss drops at least 10%, and the
     two arms' converged eval losses (the mean of the last two evaluations)
     agree within 10%.

Writes ``docs/artifacts/train_numerics_h100.json``; exits 1 when a gate
fails (``--smoke``: small shapes, a tiny model, 2 steps, no gates).

Usage: python scripts/check_train_numerics_torch.py [--steps 150] [--batch 16] [--device cuda]
       [--cpu_threads N] [--smoke] [--out PATH]
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

ART = os.path.join(gates_torch.ARTIFACTS, "train_numerics_h100.json")
OP_NAMES = ("out", "d_edge_attr", "d_sender", "d_sh", "d_w1", "d_b1", "d_w2", "d_b2")
PER_EDGE = 4  # the output and the per-edge gradients, held at KERNEL_RTOL; the weight gradients at SUM_RTOL


def specs():
    """Production irreps specs: (name, irreps_in, irreps_sh, irreps_out, with_dmask)."""
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.models.score_model import get_irrep_seq
    from confidence_bootstrapping_tpu_torch.ops.irreps import FullTensorProduct

    c = ScoreModelConfig(lm_embedding_dim=0)
    trunk = get_irrep_seq(c.ns, c.nv, c.reduce_pseudoscalars, c.use_second_order_repr)[3]
    tor_sh = str(FullTensorProduct("1x0e + 1x1o", "1x2e").irreps_out)
    cc = ScoreModelConfig(ns=24, nv=6, sh_lmax=2, all_atoms=True, confidence_mode=True)
    aa_trunk = get_irrep_seq(cc.ns, cc.nv, cc.reduce_pseudoscalars, cc.use_second_order_repr)[3]
    return [
        ("cg_trunk_l1", trunk, "1x0e + 1x1o", trunk, True),
        ("torsion_head", trunk, tor_sh, f"{c.ns}x0o + {c.ns}x0e", False),
        ("aa_trunk_l2", aa_trunk, "1x0e + 1x1o + 1x2e", aa_trunk, False),
    ]


def op_inputs(irin: str, irsh: str, irout: str, with_dmask: bool, M: int, K: int, H: int, Fe: int = 96):
    """The JAX script's seeded inputs of one spec (``RandomState(7)``, its
    draw order) as numpy arrays, with the cotangent."""
    from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

    tp = WeightedTensorProduct(irin, irsh, irout)
    rng = np.random.RandomState(7)
    x = dict(edge_attr=rng.randn(M, K, Fe).astype(np.float32),
             sender=rng.randn(M, K, tp.irreps_in.dim).astype(np.float32),
             sh=rng.randn(M, K, tp.irreps_sh.dim).astype(np.float32))
    x["mask"] = rng.rand(M, K) > 0.15
    x["dmask"] = (rng.rand(M, K, 1) > 0.1).astype(np.float32) / 0.9 if with_dmask else None
    x["w1"] = (rng.randn(Fe, H) / np.sqrt(Fe)).astype(np.float32)
    x["b1"] = (rng.randn(H) * 0.1).astype(np.float32)
    x["w2"] = (rng.randn(H, tp.weight_numel) / np.sqrt(H)).astype(np.float32)
    x["b2"] = (rng.randn(tp.weight_numel) * 0.1).astype(np.float32)
    x["cot"] = rng.randn(M, tp.irreps_out.dim).astype(np.float32)
    return x


def op_run(x: dict, irreps: tuple, dev, mask=None) -> list:
    """[output, d_edge_attr, d_sender, d_sh, d_w1, d_b1, d_w2, d_b2] of the
    port's differentiable edge op on ``dev`` (K-summed), as CPU tensors."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_train

    t = lambda a: torch.as_tensor(a, device=dev)
    leaves = [t(x[n]).requires_grad_(True) for n in ("edge_attr", "sender", "sh", "w1", "b1", "w2", "b2")]
    ea, s, sh, w1, b1, w2, b2 = leaves
    out = tpconv_train.fused_tpconv_train(ea, s, sh, t(x["mask"]) if mask is None else mask.to(dev), w1, b1, w2, b2,
                                          *irreps, dmask=None if x["dmask"] is None else t(x["dmask"]), sum_k=True)
    grads = torch.autograd.grad(out, leaves, t(x["cot"]))
    return [v.detach().cpu() for v in (out, *grads)]


def part_a(dev, M: int, K: int, H: int) -> tuple:
    """(rows per spec, ok): the card op against the CPU op per spec."""
    import torch

    import chip_smoke

    rows, ok = {}, True
    for name, irin, irsh, irout, with_dmask in specs():
        x = op_inputs(irin, irsh, irout, with_dmask, M, K, H)
        near = chip_smoke.near_relu_boundary(torch.as_tensor(x["edge_attr"]), torch.as_tensor(x["w1"]),
                                             torch.as_tensor(x["b1"]))
        mask = torch.as_tensor(x["mask"]) & ~near
        t0 = time.perf_counter()
        got = op_run(x, (irin, irsh, irout), dev, mask)
        gates_torch.sync(dev)
        t_dev = time.perf_counter() - t0
        ref = op_run(x, (irin, irsh, irout), "cpu", mask)
        row = {"irreps_in": irin, "irreps_sh": irsh, "irreps_out": irout, "dmask": with_dmask,
               "M": M, "K": K, "H": H, "edges": int(x["mask"].sum()), "edges_at_relu_left_out": int((near & torch.as_tensor(x["mask"])).sum()),
               "op_wall_s": round(t_dev, 4), "min_cos": 1.0, "worst_norm_ratio": 1.0, "n": 0, "tensors": {}}
        for i, (tag, g, w) in enumerate(zip(OP_NAMES, got, ref)):
            g64, w64 = g.double().ravel(), w.double().ravel()
            err, scale = float((g64 - w64).abs().max()), float(w64.abs().max())
            tol = (chip_smoke.KERNEL_RTOL if i < PER_EDGE else chip_smoke.SUM_RTOL) * max(1.0, scale)
            ng, nw = float(g64.norm()), float(w64.norm())
            cos = float(g64 @ w64 / max(ng * nw, 1e-30))
            ratio = ng / max(nw, 1e-30)
            row["tensors"][tag] = {"max_abs_err": err, "tolerance": tol, "ok": err <= tol, "cos": round(cos, 7),
                                   "norm_ratio": round(ratio, 7)}
            ok &= err <= tol
            if i > 0 and (nw > 1e-12 or ng > 1e-12):  # the JAX script's statistics, over the cotangents
                row["min_cos"] = round(min(row["min_cos"], cos), 7)
                if abs(np.log(max(ratio, 1e-30))) > abs(np.log(max(row["worst_norm_ratio"], 1e-30))):
                    row["worst_norm_ratio"] = round(ratio, 7)
                row["n"] += 1
        row["ok"] = all(v["ok"] for v in row["tensors"].values())
        rows[name] = row
        print(f"A {name}: ok={row['ok']} min_cos {row['min_cos']} worst_norm_ratio {row['worst_norm_ratio']} "
              f"errors {({k: v['max_abs_err'] for k, v in row['tensors'].items()})}", flush=True)
    return rows, ok


class CpuDraws:
    """Every random number of a training or eval step drawn from the CPU
    generator the step is given and moved to the batch's device: the
    diffusion times and noise (``train_loop.apply_noise``) and the dropout
    masks (``layers.dropout_mask``). Installed while the harness runs."""

    def __init__(self):
        from confidence_bootstrapping_tpu_torch.models import layers
        from confidence_bootstrapping_tpu_torch.train import train_loop

        self.saved = [(train_loop, "apply_noise", train_loop.apply_noise),
                      (layers, "dropout_mask", layers.dropout_mask)]

    def __enter__(self):
        from confidence_bootstrapping_tpu_torch.models import layers
        from confidence_bootstrapping_tpu_torch.train import diffusion, train_loop

        draw_mask = layers.dropout_mask

        def apply_noise(batch, sigma, cfg, generator, no_torsion=False):
            dev = batch.lig_pos.device
            draws = diffusion.draw_noise(batch.map(lambda a: a.cpu()), sigma, cfg, generator)
            return diffusion.apply_draws(batch, type(draws)(*(d.to(dev) for d in draws)), sigma, no_torsion)

        train_loop.apply_noise = apply_noise
        layers.dropout_mask = lambda shape, p, generator, device: draw_mask(shape, p, generator, "cpu").to(device)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def trajectory(dev, model_cfg, init_state: dict, batch_cpu, steps: int, draws: int, every: int) -> dict:
    """One arm of part B on ``dev``: {losses, evals, wall_s}."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import TrainConfig
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.train import train_loop

    model = get_model(model_cfg, device=dev)
    model.load_state_dict(init_state)
    batch = batch_cpu.map(lambda a: a.to(dev))
    tcfg = TrainConfig(lr=1e-3, batch_size=batch.batch_size)
    state = train_loop.init_train_state(model, tcfg)
    step = train_loop.make_train_step(model_cfg, tcfg)
    eval_step = train_loop.make_eval_step(model_cfg, tcfg, use_running_average=False)

    def mean_eval():
        return float(np.mean([float(eval_step(state, batch, torch.Generator().manual_seed(42 + 7 * j))["loss"])
                              for j in range(draws)]))

    t0 = time.perf_counter()
    with CpuDraws():
        gen = torch.Generator().manual_seed(1000)
        losses, evals = [], [mean_eval()]
        for i in range(steps):
            losses.append(float(step(state, batch, gen)["loss"]))
            if (i + 1) % every == 0 or i == steps - 1:
                evals.append(mean_eval())
                print(f"B {dev.type} step {i + 1}: eval {evals[-1]:.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    return {"losses": losses, "evals": evals, "wall_s": round(time.perf_counter() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--eval_draws", type=int, default=8)
    ap.add_argument("--eval_every", type=int, default=5)
    ap.add_argument("--cpu_threads", type=int, default=0, help="torch threads of the CPU arm (0: torch's default)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=ART)
    args = ap.parse_args(argv)
    dev = gates_torch.device(args.device)

    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model

    if args.cpu_threads:
        torch.set_num_threads(args.cpu_threads)
    gates_torch.warm_tables(dev)
    M, K, H = (16, 4, 16) if args.smoke else (1024, 16, 128)
    tiny = {}
    if args.smoke:
        args.steps, args.batch, args.eval_draws, args.eval_every = 2, 2, 2, 1
        tiny = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    ok = True
    art = {"criterion_note": (
        "full-model grad-direction cosine across devices at random init is ill-conditioned (see "
        "scripts/check_train_numerics.py) and is NOT a gate; part A holds the card op against the CPU op within the "
        "training-op tolerance of chip_smoke.py phase 7, part B the two arms' eval losses")}

    parity, a_ok = part_a(dev, M, K, H)
    art["op_backward_parity"] = parity
    art["op_specs_not_taken"] = []  # every production spec runs the port's differentiable op
    ok &= a_ok

    hc, _ = gates_torch.load_1a0q(0)
    padded = pad_complex(hc, pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)),
                         lm_dim=0)
    batch_cpu = replicate_complex(padded, args.batch, device="cpu")
    model_cfg = ScoreModelConfig(lm_embedding_dim=0, **tiny)
    init_state = {k: v.cpu() for k, v in get_model(model_cfg, device="cpu", seed=0).state_dict().items()}
    arms = {"kernel": trajectory(dev, model_cfg, init_state, batch_cpu, args.steps, args.eval_draws, args.eval_every),
            "plain": trajectory(torch.device("cpu"), model_cfg, init_state, batch_cpu, args.steps, args.eval_draws,
                                args.eval_every)}
    ep, ek = arms["plain"]["evals"], arms["kernel"]["evals"]
    lp, lk = arms["plain"]["losses"], arms["kernel"]["losses"]
    ep_tail, ek_tail = float(np.mean(ep[-2:])), float(np.mean(ek[-2:]))
    rel_tail = abs(ep_tail - ek_tail) / max(abs(ep_tail), 1e-9)
    tj = {
        "steps": args.steps, "b": args.batch, "eval_draws": args.eval_draws, "eval_every": args.eval_every,
        "b_halvings": 0 if args.smoke else int(round(np.log2(16 / args.batch))),
        "kernel_arm_device": str(dev), "plain_arm_device": "cpu",
        "eval_first_plain": round(ep[0], 4), "eval_first_kernel": round(ek[0], 4),
        "eval_tail_plain": round(ep_tail, 4), "eval_tail_kernel": round(ek_tail, 4),
        "eval_rel_diff_tail": round(rel_tail, 4),
        "mean_train_rel_diff": round(float(np.mean([abs(a - b) / max(abs(a), 1e-9) for a, b in zip(lp, lk)])), 4),
        "wall_s_kernel": arms["kernel"]["wall_s"], "wall_s_plain": arms["plain"]["wall_s"],
        "evals_plain": [round(v, 4) for v in ep], "evals_kernel": [round(v, 4) for v in ek],
        "losses_plain": [round(v, 4) for v in lp], "losses_kernel": [round(v, 4) for v in lk],
    }
    descends = ep_tail < 0.90 * ep[0] and ek_tail < 0.90 * ek[0]
    agrees = rel_tail < 0.10
    if not args.smoke:
        tj["gates"] = {"descends": descends, "agrees": agrees}
        ok &= descends and agrees
    art["trajectory"] = tj
    art["ok"] = bool(ok)
    gates_torch.write(args.out, gates_torch.stamp(art, dev))
    print(json.dumps({"ok": ok, "worst_op_cos": min(r["min_cos"] for r in parity.values()),
                      "eval_rel_diff_tail": tj["eval_rel_diff_tail"]}))
    if not args.smoke and not ok:
        print("check_train_numerics_torch: FAILED", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
