"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each one fails the script when it fails):
  1. the card's name and power limit (nvidia-smi);
  2. build every TP-conv kernel from csrc/ with nvcc for sm_90a (timed);
  3. per kernel, on every call of one sample of phase 5's path (recorded,
     then replayed): the kernel against its plain PyTorch version on the same
     inputs (stated tolerance), both timed, and its bound; by shape and as
     means over the sample's launches;
  4. the full-width score model on 1a0q at B=2: CUDA with the kernels against
     the same model and weights on the CPU with the plain versions;
  5. bench.py's path on the port: 1a0q, random ESM-sized receptor features,
     B=32 poses, seeded random weights, 20 steps, shared receptor embedding,
     phase plan 6:256,12:128; one warm-up and one timed run, poses/s, and the
     launch count of every kernel against the count the config implies;
     one more sample under torch.profiler for device time by kernel.
Then one JSON line with every kernel's numbers, and last the device line.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE_PKL = os.path.join(ROOT, "cache", "1a0q_44f574e0e5cb3bc5.pkl")
B_POSES, STEPS, LM_DIM, PLAN = 32, 20, 1280, ((6, 256), (12, 128))
# H100 SXM data-sheet peaks (dense): float32 on the CUDA cores and HBM3
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
KERNEL_RTOL = 2e-4  # max |kernel - plain| <= KERNEL_RTOL * max(1, max |plain|)
MODEL_RTOL = 1e-3  # CUDA vs CPU forward, per output, relative to its max |value|
SAMPLE_ATOL = 1e-2  # CUDA vs CPU ligand positions after a 3-step ODE sample, in A
KERNELS = ("tpconv_rec", "tpconv_pb", "tpconv_cross_rev")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


@functools.lru_cache(maxsize=None)
def flops_per_edge(irreps_in: str, irreps_out: str, Fe: int, H: int) -> int:
    """What one edge needs: the edge-feature part of the MLP's first layer
    (Fe -> H), its second layer (H -> W), the CG products and the weighted TP
    contraction. The receiver- and sender-scalar parts of the first layer
    need doing once per node (``node_flops``), not per edge."""
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout
    from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

    lay = tp_layout(irreps_in, irreps_out)
    tp = WeightedTensorProduct(irreps_in, "1x0e + 1x1o", irreps_out)
    contract = sum(g.fan_in * g.w_shape[1] * tp.irreps_out[g.out_index].ir.dim for g in tp.groups)
    cg = int(sum(r[1] * r[3] for r in lay.xtab))
    return 2 * (Fe * H + H * lay.weight_numel + contract + cg)


def node_flops(ns: int, H: int) -> int:
    """One node row's ns scalars through its part of the MLP's first layer."""
    return 2 * ns * H


def used_rows(index, mask, n: int):
    """[B * n] bool: the rows of a [B, n] node table that a valid edge reads."""
    import torch

    B = index.shape[0]
    flat = (index.reshape(B, -1) + torch.arange(B, device=index.device)[:, None] * n)[mask.reshape(B, -1)]
    used = torch.zeros(B * n, dtype=torch.bool, device=index.device)
    used[flat] = True
    return used


def rec_work(args):
    """(flops, tag) of one fused_tpconv_rec call on this data."""
    node, _, nbr, emb, _, mask, _, _, w2, _, ir_in, ir_out, ns = args
    B, N, K = nbr.shape
    H = w2.shape[0]
    rows = int(mask.any(-1).sum()) + int(used_rows(nbr, mask, N).sum())
    flops = int(mask.sum()) * flops_per_edge(ir_in, ir_out, emb.shape[-1], H) + rows * node_flops(ns, H)
    return flops, f"B={B} N={N} K={K} D {node.shape[-1]}->{tp_dout(ir_in, ir_out)}"


def pb_work(args):
    lig, _, pair_emb, pair_mask, bsrc, bdst, _, bmask, _, _, w2, _, ir_in, ir_out, ns = args
    B, L, _ = lig.shape
    H = w2.shape[0]
    recv = pair_mask.any(-1).reshape(-1) | used_rows(bsrc, bmask, L)
    send = pair_mask.any(-2).reshape(-1) | used_rows(bdst, bmask, L)
    edges = int(pair_mask.sum()) + int(bmask.sum())
    flops = edges * flops_per_edge(ir_in, ir_out, pair_emb.shape[-1], H) + int(recv.sum() + send.sum()) * node_flops(ns, H)
    return flops, f"B={B} L={L} E={bsrc.shape[1]} D {lig.shape[-1]}->{tp_dout(ir_in, ir_out)}"


def cross_work(args):
    lig, _, rec, _, idx, emb, mask, _, _, w2, _, w1_r = args[:12]
    ir_in, ir_out, ns = args[-3:]
    B, L, K = idx.shape
    N, H = rec.shape[1], w2.shape[0]
    dirs = 1 if w1_r is None else 2  # the reverse direction has its own weights: all its work again
    rows = int(mask.any(-1).sum()) + int(used_rows(idx, mask, N).sum())
    flops = dirs * (int(mask.sum()) * flops_per_edge(ir_in, ir_out, emb.shape[-1], H) + rows * node_flops(ns, H))
    return flops, f"B={B} L={L} N={N} K={K} D {lig.shape[-1]}->{tp_dout(ir_in, ir_out)}{'' if dirs == 2 else ', no reverse'}"


def tp_dout(ir_in: str, ir_out: str) -> int:
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout

    return tp_layout(ir_in, ir_out).dout


def main_path(dev):
    """bench.py's path on the port: the full-width model with seeded random
    weights; 1a0q with random ESM-sized receptor features, B=32 poses at the
    t=1 prior; 20 steps, shared receptor embedding, phase plan 6:256,12:128."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position, sample

    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM)
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    batch = replicate_complex(host_complex(LM_DIM), B_POSES, device=dev)
    N = batch.rec_pos.shape[1]
    plan = [(s, c) for s, c in PLAN if c < N]
    scfg = SamplerConfig(inference_steps=STEPS, rec_phase_steps=tuple(s for s, _ in plan),
                         rec_phase_caps=tuple(c for _, c in plan))
    b0 = randomize_position(batch, torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    print(f"main path: B={B_POSES}, {STEPS} steps, lm_dim {LM_DIM}, N={N}, phase plan {plan}", flush=True)
    # every run draws the same noise, so each runs the same data as the one phase 3 records
    return model, b0, lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)


def record_calls(run) -> dict:
    """Run ``run()`` with the three kernel wrappers, as the conv layers call
    them, wrapped to keep the inputs of every call: {kernel: [(args,
    kwargs), ...]} in call order."""
    from confidence_bootstrapping_tpu_torch.models import layers

    calls = {name: [] for name in KERNELS}
    originals = {name: getattr(layers, "fused_" + name) for name in KERNELS}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return call

    try:
        for name in KERNELS:
            setattr(layers, "fused_" + name, recorder(name))
        run()
    finally:
        for name, fn in originals.items():
            setattr(layers, "fused_" + name, fn)
    return calls


def kernel_phase(model, run) -> list:
    """Phase 3: every kernel against its plain version on what the main path
    gives it. One sample runs with the wrappers recorded; every call is
    replayed through the kernel and its plain version, both timed, with its
    bound from its own data. Printed per shape (receptor embedding at B=1,
    each phase's N and cross K, with and without reverse weights) and per
    kernel as means over the sample's launches."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_lig, tpconv_rec

    kernels = {
        "tpconv_rec": (tpconv_rec.fused_tpconv_rec, tpconv_rec.tpconv_rec_plain, rec_work,
                       "confidence_bootstrapping_tpu/ops/pallas/tpconv_rec.py:154"),
        "tpconv_pb": (tpconv_lig.fused_tpconv_pb, tpconv_lig.tpconv_pb_plain, pb_work,
                      "confidence_bootstrapping_tpu/ops/pallas/tpconv_lig.py:207"),
        "tpconv_cross_rev": (tpconv_lig.fused_tpconv_cross_rev, tpconv_lig.tpconv_cross_rev_plain, cross_work,
                             "confidence_bootstrapping_tpu/ops/pallas/tpconv_lig.py:389"),
    }
    calls = record_calls(run)
    torch.cuda.synchronize()
    counts = {name: len(calls[name]) for name in KERNELS}
    want = expected_launches(model, STEPS)
    print(f"recorded sample: calls {counts}, expected from the config {want}", flush=True)
    if counts != want:
        fail("the recorded sample did not run every TP-conv through its wrapper")

    def outputs(o):
        return [t for t in (o if isinstance(o, tuple) else (o,)) if t is not None]

    rows = []
    for name, (fn, plain, work, replaces) in kernels.items():
        shapes = {}  # tag -> per-call measurements
        for args, kwargs in calls[name]:
            got, ref = outputs(fn(*args, **kwargs)), outputs(plain(*args))
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, ref))
            scale = max(w.abs().max().item() for w in ref)
            flops, tag = work(args)
            bound_bytes = nbytes(*(a for a in args if torch.is_tensor(a)), *got) / PEAK_BYTES * 1e3
            bound_ops = flops / PEAK_FP32_FLOPS * 1e3
            shapes.setdefault(tag, []).append(dict(
                err=err, rel=err / max(scale, 1e-30), ok=err <= KERNEL_RTOL * max(1.0, scale),
                ms=cuda_time(lambda: fn(*args, **kwargs), reps=5, warmup=1),
                plain_ms=cuda_time(lambda: plain(*args), reps=2, warmup=0),
                bound_bytes=bound_bytes, bound_ops=bound_ops, bound=max(bound_bytes, bound_ops), flops=flops))
        every = [m for ms in shapes.values() for m in ms]
        for tag, ms in list(shapes.items()) + [("all", every)]:
            mean = {k: float(np.mean([m[k] for m in ms])) for k in ("ms", "plain_ms", "bound", "bound_ops", "bound_bytes", "flops")}
            ok = all(m["ok"] for m in ms)
            print(f"kernel {name} [{tag}], {len(ms)} calls: max_abs_err {max(m['err'] for m in ms):.3g} (max rel "
                  f"{max(m['rel'] for m in ms):.3g}; tolerance {KERNEL_RTOL} x max(1, max |plain|)) "
                  f"{'ok' if ok else 'MISMATCH'}; mean kernel {mean['ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms, "
                  f"bound {mean['bound']:.4f} ms ({'operations' if mean['bound_ops'] >= mean['bound_bytes'] else 'bytes'}; "
                  f"{mean['flops']:.4g} flops); per sample {mean['ms'] * len(ms):.2f} ms", flush=True)
            if not ok:
                fail(f"kernel {name} [{tag}] disagrees with its plain version")
        # ``mean`` now holds the means over every call ("all", the last tag)
        rows.append(dict(name=name, route="cuda", source=f"confidence_bootstrapping_tpu_torch/csrc/{name}.cu",
                         replaces=replaces, max_abs_err=max(m["err"] for m in every), ms=mean["ms"],
                         plain_ms=mean["plain_ms"], bound_ms=mean["bound"],
                         bound_by="operations" if mean["bound_ops"] >= mean["bound_bytes"] else "bytes", library_ms=None))
        torch.cuda.synchronize()
    return rows


def host_complex(lm_dim: int):
    """1a0q from the committed featurization cache, with random ESM-sized
    receptor features as bench.py makes them."""
    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_complex, pad_complex, pick_bucket

    hc = load_host_complex(CACHE_PKL)
    hc = hc._replace(rec_lm=np.random.RandomState(0).randn(len(hc.rec_f), lm_dim).astype(np.float32))
    bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))
    return pad_complex(hc, bucket, lm_dim=lm_dim)


def model_phase(dev) -> None:
    """Phase 4: the full-width model forward on 1a0q at B=2 on the card (with
    the kernels) against the same model and weights on the CPU (with the plain
    versions); then a 3-step probability-flow sample with two compaction
    boundaries, card against CPU."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import sample

    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM)
    padded = host_complex(LM_DIM)
    pos = padded["lig_pos"][None] + np.random.RandomState(1).randn(2, *padded["lig_pos"].shape).astype(np.float32) * 2
    ref_pos = None
    for device in (dev, torch.device("cpu")):  # the card first: it builds the score-norm tables
        model = TensorProductScoreModel(cfg, device=device, seed=0)
        batch = replicate_complex(padded, 2, device=device).replace(lig_pos=torch.as_tensor(pos, device=device))
        out = model(batch.set_time(0.5, 0.5, 0.5))
        final, _ = sample(model, batch, cfg, SamplerConfig(inference_steps=3, ode=True, rec_phase_steps=(1, 2),
                                                           rec_phase_caps=(256, 128)), device=device)
        if ref_pos is None:
            torch.cuda.synchronize()
            got = [t.cpu() for t in out]
            ref_pos = final.lig_pos.cpu()
            continue
        for name, g, w in zip(("tr_pred", "rot_pred", "tor_pred"), got, out):
            peak = w.abs().max().item()
            err = (g - w).abs().max().item()
            print(f"model forward {name}: max_abs_err {err:.3g} (max |cpu| {peak:.3g}, tolerance {MODEL_RTOL} x "
                  f"max(1, max |cpu|))", flush=True)
            if not (err <= MODEL_RTOL * max(1.0, peak) and torch.isfinite(g).all()):
                fail(f"model forward {name}: the card disagrees with the CPU")
        err = (ref_pos - final.lig_pos).abs().max().item()
        moved = (final.lig_pos - batch.lig_pos).abs().max().item()
        print(f"3-step ODE sample with compaction: max_abs_err {err:.3g} A (tolerance {SAMPLE_ATOL} A), poses moved "
              f"{moved:.3g} A", flush=True)
        if not (err <= SAMPLE_ATOL and moved > 0.1):
            fail("the 3-step sample on the card disagrees with the CPU")


def expected_launches(model, steps: int) -> dict:
    """Kernel launches of one shared-receptor sample: the receptor embedding
    once, then per step every ligand conv (embedding and trunk) on pb, every
    trunk layer on cross_rev, and every trunk layer but the last on rec."""
    n_emb, n_trunk = len(model.rec_emb_layers), len(model.conv_layers)
    return {"tpconv_rec": n_emb + (n_trunk - 1) * steps,
            "tpconv_pb": (len(model.lig_emb_layers) + n_trunk) * steps,
            "tpconv_cross_rev": n_trunk * steps}


def sample_phase(model, b0, run) -> dict:
    """Phase 5: the main path, timed. Returns the kernel launches of the
    timed sample."""
    import torch

    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    print(f"sample warm-up: {time.perf_counter() - t0:.3f} s", flush=True)

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_lig, tpconv_rec

    counters = {"tpconv_rec": tpconv_rec.fused_tpconv_rec, "tpconv_pb": tpconv_lig.fused_tpconv_pb,
                "tpconv_cross_rev": tpconv_lig.fused_tpconv_cross_rev}  # each counts its launches
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, _ = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    pos = final.lig_pos
    moved = (pos - b0.lig_pos)[b0.lig_mask].norm(dim=-1).mean().item()
    print(f"sample: {secs:.4f} s, {B_POSES / secs:.3f} poses/s; mean atom displacement {moved:.3g} A", flush=True)
    if tuple(pos.shape) != tuple(b0.lig_pos.shape) or not torch.isfinite(pos).all() or not moved > 0.1:
        fail("final poses are not finite or did not move")
    want = expected_launches(model, STEPS)
    print(f"launches in the timed sample: {launches}; expected from the config: {want}", flush=True)
    if launches != want:
        fail("the main path did not run every TP-conv through its kernel")
    profile_sample(run, secs * 1e3)
    return launches


def profile_sample(run, timed_ms: float) -> None:
    """One more sample under torch.profiler: device time by kernel and the
    device's idle share of the wall time, of this run and of the unprofiled
    timed run (same kernels, less host overhead). A measurement, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    if not dev_events:
        print(f"profile: wall {wall_ms:.1f} ms; torch.profiler recorded no device time", flush=True)
        return
    print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f} "
          f"(of the unprofiled run's {timed_ms:.1f} ms: {1 - busy_ms / timed_ms:.3f}); device time by kernel:",
          flush=True)
    for e in dev_events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:90]}")
    rest = dev_events[12:]
    print(f"  {sum(e.self_device_time_total for e in rest) / 1e3:9.2f} ms  {sum(e.count for e in rest):5d}x  "
          f"{len(rest)} other kernels", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.exists(CACHE_PKL):
        fail(f"{CACHE_PKL} not found: run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import confidence_bootstrapping_tpu_torch  # noqa: F401  (switches TF32 off)
    from confidence_bootstrapping_tpu_torch.ops.cuda import build

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")

    secs, logs = build.timed_build()
    print(f"build: {len(logs)} kernels with nvcc for sm_90a in {secs:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  {name}: {line.strip()}")

    model, b0, run = main_path(dev)
    rows = kernel_phase(model, run)
    torch.cuda.synchronize()
    model_phase(dev)
    torch.cuda.synchronize()
    launches = sample_phase(model, b0, run)
    torch.cuda.synchronize()

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
