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
     one more sample under torch.profiler for device time by kernel;
  6. the confidence rerank on the port: the full-width pretrained confidence
     architecture (all-atom, lmax=2) with seeded random weights on 1a0q with
     seeded receptor atoms (3183 over the 416 residues); phase 5's 32 final
     poses scored and ranked as the dock CLI ranks them; then 32 poses near
     the crystal pose scored with one warm-up and one timed forward (poses/s,
     the crop's kept residues and atoms, launches of rec_g and cross_g against
     the config), the card against the CPU on 2 of them, every rec_g and
     cross_g call of the timed forward replayed through kernel and plain
     version as in phase 3, and one forward under torch.profiler.
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
KERNELS = ("tpconv_rec", "tpconv_pb", "tpconv_cross_rev")  # the score model's (lmax=1)
CONF_KERNELS = ("tpconv_rec_g", "tpconv_cross_g")  # the confidence model's (lmax=2)
N_ATOMS = 3183  # 1a0q's receptor heavy atoms over its 416 residues
SH1, SH2 = "1x0e + 1x1o", "1x0e + 1x1o + 1x2e"


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
def flops_per_edge(irreps_in: str, irreps_out: str, Fe: int, H: int, irreps_sh: str = SH1) -> int:
    """What one edge needs: the edge-feature part of the MLP's first layer
    (Fe -> H), its second layer (H -> W), the CG products and the weighted TP
    contraction. The receiver- and sender-scalar parts of the first layer
    need doing once per node (``node_flops``), not per edge."""
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout
    from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
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
    """(flops, tag) of one fused_tpconv_rec (13 arguments) or
    fused_tpconv_rec_g (14, with the harmonics) call on this data."""
    node, _, nbr, emb, _, mask, _, _, w2, _ = args[:10]
    ir_in, ir_sh, ir_out, ns = (args[10], SH1, *args[11:]) if len(args) == 13 else args[10:]
    B, N, K = nbr.shape
    H = w2.shape[0]
    rows = int(mask.any(-1).sum()) + int(used_rows(nbr, mask, N).sum())
    flops = int(mask.sum()) * flops_per_edge(ir_in, ir_out, emb.shape[-1], H, ir_sh) + rows * node_flops(ns, H)
    return flops, f"B={B} N={N} K={K} D {node.shape[-1]}->{tp_dout(ir_in, ir_out, ir_sh)}"


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


def cross_g_work(args):
    """(flops, tag) of one fused_tpconv_cross_g call: one direction."""
    recv, _, src, _, idx, emb, mask, _, _, w2, _, ir_in, ir_sh, ir_out, ns = args
    B, L, K = idx.shape
    N, H = src.shape[1], w2.shape[0]
    rows = int(mask.any(-1).sum()) + int(used_rows(idx, mask, N).sum())
    flops = int(mask.sum()) * flops_per_edge(ir_in, ir_out, emb.shape[-1], H, ir_sh) + rows * node_flops(ns, H)
    return flops, f"B={B} L={L} N={N} K={K} D {recv.shape[-1]}->{tp_dout(ir_in, ir_out, ir_sh)}"


def tp_dout(ir_in: str, ir_out: str, ir_sh: str = SH1) -> int:
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout

    return tp_layout(ir_in, ir_out, ir_sh).dout


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
    batch = replicate_complex(host_complex(LM_DIM)[0], B_POSES, device=dev)
    N = batch.rec_pos.shape[1]
    plan = [(s, c) for s, c in PLAN if c < N]
    scfg = SamplerConfig(inference_steps=STEPS, rec_phase_steps=tuple(s for s, _ in plan),
                         rec_phase_caps=tuple(c for _, c in plan))
    b0 = randomize_position(batch, torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    print(f"main path: B={B_POSES}, {STEPS} steps, lm_dim {LM_DIM}, N={N}, phase plan {plan}", flush=True)
    # every run draws the same noise, so each runs the same data as the one phase 3 records
    return model, b0, lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)


def record_calls(run, names=KERNELS) -> dict:
    """Run ``run()`` with the named kernel wrappers, as the conv layers call
    them, wrapped to keep the inputs of every call: {kernel: [(args,
    kwargs), ...]} in call order."""
    from confidence_bootstrapping_tpu_torch.models import layers

    calls = {name: [] for name in names}
    originals = {name: getattr(layers, "fused_" + name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return call

    try:
        for name in names:
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
    return replay(calls, kernels)


def replay(calls: dict, kernels: dict) -> list:
    """Replay every recorded call through its kernel and its plain version:
    error against the stated tolerance, both timed, the bound from the
    call's own data. Prints per shape and as means over the calls; returns
    one JSON row per kernel (without ``launches``)."""
    import torch

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
                  f"{mean['flops']:.4g} flops); per run {mean['ms'] * len(ms):.2f} ms", flush=True)
            if not ok:
                fail(f"kernel {name} [{tag}] disagrees with its plain version")
        # ``mean`` now holds the means over every call ("all", the last tag)
        rows.append(dict(name=name, route="cuda", source=f"confidence_bootstrapping_tpu_torch/csrc/{name}.cu",
                         replaces=replaces, max_abs_err=max(m["err"] for m in every), ms=mean["ms"],
                         plain_ms=mean["plain_ms"], bound_ms=mean["bound"],
                         bound_by="operations" if mean["bound_ops"] >= mean["bound_bytes"] else "bytes", library_ms=None))
        torch.cuda.synchronize()
    return rows


def host_complex(lm_dim: int, all_atoms: bool = False):
    """1a0q from the committed featurization cache, with random ESM-sized
    receptor features as bench.py makes them; with ``all_atoms``, seeded
    receptor atoms too (``receptor_atoms``) in the all-atom bucket."""
    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_complex, pad_complex, pick_bucket

    hc = load_host_complex(CACHE_PKL)
    hc = hc._replace(rec_lm=np.random.RandomState(0).randn(len(hc.rec_f), lm_dim).astype(np.float32))
    if all_atoms:
        hc = hc._replace(**receptor_atoms(hc.rec_f, hc.rec_pos, N_ATOMS))
    bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                         n_atoms=N_ATOMS if all_atoms else 0, all_atoms=all_atoms)
    return pad_complex(hc, bucket, lm_dim=lm_dim), hc


def receptor_atoms(rec_f, rec_pos, n_atoms: int, seed: int = 0, radius: float = 5.0, k: int = 8):
    """Seeded stand-in for the all-atom featurization of a receptor (the
    repository holds no structure file to featurize): n_atoms heavy atoms,
    at least 4 per residue (N, CA, C, O) and the rest spread at random, each
    within 4 A of its residue's C-alpha; categorical features within
    REC_ATOM_FEATURE_DIMS (the residue's type, then random element and atom
    names); kNN lists of k within ``radius`` from the port's featurization
    code. -> dict of HostComplex atom fields."""
    from confidence_bootstrapping_tpu_torch.data.complex_graph import atom_knn
    from confidence_bootstrapping_tpu_torch.data.vocab import REC_ATOM_FEATURE_DIMS

    rng = np.random.RandomState(seed)
    n_res = len(rec_pos)
    counts = np.full(n_res, 4) + np.bincount(rng.randint(0, n_res, n_atoms - 4 * n_res), minlength=n_res)
    atom_res = np.repeat(np.arange(n_res), counts)
    offset = rng.randn(n_atoms, 3) * 1.5
    offset *= np.minimum(1.0, 4.0 / np.linalg.norm(offset, axis=-1, keepdims=True))
    atom_pos = (rec_pos[atom_res] + offset).astype(np.float32)
    atom_f = np.stack([np.asarray(rec_f)[atom_res]] + [rng.randint(0, n, n_atoms) for n in REC_ATOM_FEATURE_DIMS[1:]], -1)
    nbr, nbr_mask = atom_knn(atom_pos, radius, k)
    return dict(atom_f=atom_f.astype(np.int64), atom_pos=atom_pos, atom_nbr=nbr, atom_nbr_mask=nbr_mask,
                atom_res=atom_res.astype(np.int64))


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
    padded, _ = host_complex(LM_DIM)
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


def sample_phase(model, b0, run):
    """Phase 5: the main path, timed. Returns (the kernel launches of the
    timed sample, its final ligand positions [B, L, 3])."""
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
    profile_run(run, secs * 1e3)
    return launches, pos


def profile_run(run, timed_ms: float) -> None:
    """One more run under torch.profiler: device time by kernel and the
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


def expected_conf_launches(model) -> dict:
    """Kernel launches of one confidence forward: per embedding layer and
    per trunk layer but the last, the receptor and atom kNN groups on rec_g;
    per trunk layer, the ligand <- receptor and ligand <- atom groups on
    cross_g."""
    return {"tpconv_rec_g": 2 * (len(model.rec_emb_layers) + len(model.conv_layers) - 1),
            "tpconv_cross_g": 2 * len(model.conv_layers)}


def near_crystal_poses(padded: dict, n: int, seed: int = 2):
    """n poses from the crystal ligand with seeded small rigid and torsion
    noise (translation 1 A, rotation 0.2 rad and torsions 0.5 rad rms per
    axis), so that the crop keeps a pocket-sized view: [n, L, 3] float32."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.poses import modify_conformer

    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a)[None].repeat(n, 0))
    R = padded["tor_src"].shape[0]
    pos = modify_conformer(t(padded["lig_pos"]), t(padded["lig_mask"]),
                           torch.as_tensor(rng.randn(n, 3).astype(np.float32)),
                           torch.as_tensor((rng.randn(n, 3) * 0.2).astype(np.float32)),
                           torch.as_tensor((rng.randn(n, R) * 0.5).astype(np.float32)),
                           t(padded["tor_src"]), t(padded["tor_dst"]), t(padded["mask_rotate"]), t(padded["tor_mask"]))
    return pos.float()


def confidence_phase(dev, final_pos) -> tuple:
    """Phase 6: the confidence rerank (see the module docstring). Returns
    (the replay's JSON rows, the launches of the timed forward)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import confidence_model_config
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel, compact_crop
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

    cfg = confidence_model_config(lm_embedding_dim=LM_DIM)
    padded, hc = host_complex(LM_DIM, all_atoms=True)
    padded["lig_pos"][: len(hc.orig_lig_pos)] = hc.orig_lig_pos  # the crystal pose
    model = AllAtomScoreModel(cfg, device=dev, seed=0)
    batch = replicate_complex(padded, B_POSES, device=dev)
    print(f"confidence model: ns={cfg.ns} nv={cfg.nv} sh_lmax={cfg.sh_lmax}, {cfg.num_conv_layers} trunk layers, "
          f"lm_dim {LM_DIM}; 1a0q buckets N={batch.rec_pos.shape[1]} A={batch.atom_pos.shape[1]} "
          f"L={batch.lig_pos.shape[1]} ({N_ATOMS} seeded atoms); crop {cfg.crop_beyond} A into "
          f"N={cfg.crop_res_cap} A={cfg.crop_atom_cap}", flush=True)

    # the dock flow: score the sampled poses and rank them as cli/dock.py does
    conf = score_confidence(model, batch, lig_pos=final_pos.to(dev)).cpu().numpy()
    order = np.argsort(-np.nan_to_num(conf, nan=-1e9))
    print(f"rerank of phase 5's {len(conf)} poses: top confidences "
          f"{', '.join(f'pose {i}: {conf[i]:.4f}' for i in order[:5])}", flush=True)
    if conf.shape != (B_POSES,) or not np.isfinite(conf).all():
        fail("confidences of the sampled poses are not finite")

    # the timed forward, on poses near the crystal pose
    poses = near_crystal_poses(padded, B_POSES).to(dev)
    _, stats = compact_crop(batch.replace(lig_pos=poses), float(cfg.crop_beyond), cfg.crop_res_cap, cfg.crop_atom_cap)
    st = {k: v.cpu().numpy() for k, v in stats.items()}
    print(f"crop per pose: kept residues {st['kept_res'].min()}-{st['kept_res'].max()} (overflow "
          f"{st['res_overflow'].max()}), kept atoms {st['kept_atoms'].min()}-{st['kept_atoms'].max()} (overflow "
          f"{st['atom_overflow'].max()})", flush=True)
    run = lambda: score_confidence(model, batch, lig_pos=poses)
    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    print(f"confidence warm-up: {time.perf_counter() - t0:.3f} s", flush=True)
    counters = {"tpconv_rec_g": tpconv_g.fused_tpconv_rec_g, "tpconv_cross_g": tpconv_g.fused_tpconv_cross_g}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    conf = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"confidence forward: {secs:.4f} s, {B_POSES / secs:.3f} poses/s; confidences "
          f"{conf.min().item():.4f} to {conf.max().item():.4f}", flush=True)
    if conf.shape != (B_POSES,) or not torch.isfinite(conf).all():
        fail("confidences are not finite")
    want = expected_conf_launches(model)
    print(f"launches in the timed forward: {launches}; expected from the config: {want}", flush=True)
    if launches != want:
        fail("the confidence forward did not run every lmax=2 TP-conv through its kernel")

    # the card against the port's CPU path on 2 poses
    cpu_model = AllAtomScoreModel(cfg, device="cpu", seed=0)
    ref = score_confidence(cpu_model, replicate_complex(padded, 2, device="cpu"), lig_pos=poses[:2].cpu())
    err, peak = (conf[:2].cpu() - ref).abs().max().item(), ref.abs().max().item()
    print(f"confidence card vs CPU on 2 poses: max_abs_err {err:.3g} (max |cpu| {peak:.3g}, tolerance {MODEL_RTOL} x "
          f"max(1, max |cpu|))", flush=True)
    if not err <= MODEL_RTOL * max(1.0, peak):
        fail("confidence: the card disagrees with the CPU")

    calls = record_calls(run, CONF_KERNELS)
    torch.cuda.synchronize()
    kernels = {
        "tpconv_rec_g": (tpconv_g.fused_tpconv_rec_g, tpconv_g.tpconv_rec_g_plain, rec_work,
                         "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:457"),
        "tpconv_cross_g": (tpconv_g.fused_tpconv_cross_g, tpconv_g.tpconv_cross_g_plain, cross_g_work,
                           "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:547"),
    }
    rows = replay(calls, kernels)
    profile_run(run, secs * 1e3)
    return rows, launches


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
    launches, final_pos = sample_phase(model, b0, run)
    torch.cuda.synchronize()
    conf_rows, conf_launches = confidence_phase(dev, final_pos)
    torch.cuda.synchronize()

    launches.update(conf_launches)
    rows += conf_rows
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
