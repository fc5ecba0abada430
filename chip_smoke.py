"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each one fails the script when it fails):
  1. the card's name and power limit (nvidia-smi);
  2. build every TP-conv kernel from csrc/ with nvcc for sm_90a (timed), with
     each kernel's ptxas line and each library's count of HGMMA (wgmma)
     instructions from cuobjdump -sass: rec, pb, cross_rev and rec_g, whose
     H -> W product runs on the tensor cores, must have some, and their
     tensor-core kernels no spill;
  3. per kernel, on every call of one sample of phase 5's path (recorded,
     then replayed): the kernel against its plain PyTorch version on the same
     inputs (stated tolerance), both timed, and its two bounds (``bounds``:
     the tensor-core bound and the float32 one); by shape and as means over
     the sample's launches; rec's and pb's output bit for bit across two
     launches;
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
     version as in phase 3 (rec_g bit for bit across two launches), and one
     forward under torch.profiler;
  7. training: one step of the full-width score model at B=2 and dropout 0,
     the card against the CPU (loss, every parameter's gradient, the batch
     statistics after it); then TrainConfig() steps at B=16 (1a0q replicated)
     with dropout 0.1: one warm-up and 5 timed steps (median ms, training
     poses/s, the split into noise + forward, backward and optimiser + EMA by
     CUDA events, the launches per step of the edge-list forward, rec with the
     dropout mask and the edge backward against the config), the eval loss in
     batch-statistics mode over 8 fixed draws before and after them, every
     call of one more step replayed through kernel and plain version (and the
     two autograd ops forward and backward), one step under torch.profiler.
  8. the evaluator's path with a pinned cross cap (``cli/infer.py:355-571``
     for one complex): the full-width score model with cross_cap=100 and
     cross_cap_frac=0 (``infer --cross_cap 100``), so the cross lists' K=100
     is off the 16-grid at every receptor bucket and the trunk composes
     ligand <- receptor (row 4, ``tpconv_cross``) and receptor <- ligand
     (row 6, ``tpconv_msgs``, then a scatter) instead of cross_rev; the
     phase plan from ``derive_phase_plan``, the cross-cap telemetry, a warm
     and a timed B=32 20-step sample (poses/s, launches against the config),
     the rerank with phase 6's confidence model, symmetry RMSDs against the
     crystal pose (card against CPU), centroid and self distances, the
     metrics dictionary, one sample under torch.profiler;
     8b. row 5 (``tpconv_nbr``): the ligand padded to its own 23 atoms, so
     the pairs leave pb, in a 3-step ODE sample at B=8 and a B=2 forward
     (card against CPU), then phase 8's B=32 20-step sample at this bucket on
     the card (warm, then timed: poses/s, launches against the config);
     then every row 4/5/6 call of one sample of each replayed through kernel
     and plain version, and row 13's v1 API (rows 5 and 6 behind the v1
     signatures, no kernel of its own) on a few of them, printed.
  9. the wide ladder: the score model at ns=48/nv=10 (H=144, above the
     tensor-core stage's 96; DiffDock's published width), otherwise phase 5's
     model with seeded random weights: the host mirror of the kernels'
     shared-memory layouts against every library's exported bytes; one
     B=2 training step's calls (the edge backward at H=144, the edge-list
     forward and rec with the dropout mask) replayed through kernel and
     plain version; a 3-step ODE sample at B=8, card against CPU; then the
     B=32 20-step 1a0q sample: one run recorded and every rec, pb and
     cross_rev call of it (each layer pair, each phase's N, with and
     without reverse weights; the float32 builds at 32 edges a chunk)
     replayed through kernel and plain version as in phase 3, then one
     timed with its launch counts and one more under torch.profiler.
Then one JSON line with every kernel's numbers (launches per 20-step sample
for phase 3's kernels and rows 4, 5 and 6, per confidence forward for phase
6's, per training step for phase 7's; ``bound_ms`` the tensor-core bound,
``bound_fp32_ms`` the float32 one), and last the device line.
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
# H100 SXM data-sheet peaks (dense): float32 on the CUDA cores, TF32 on the tensor cores, and HBM3
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 67e12, 495e12, 3.35e12
TC_PRODUCTS = 3  # 3xTF32: h_lo w_hi + h_hi w_lo + h_hi w_hi for float32 accuracy
TC_KERNELS = ("tpconv_rec", "tpconv_pb", "tpconv_cross_rev", "tpconv_rec_g")  # H -> W on wgmma
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


def mm_flops_per_edge(irreps_in: str, irreps_out: str, Fe: int, H: int, irreps_sh: str = SH1) -> int:
    """The part of ``flops_per_edge`` that tensor cores can carry: the MLP's
    two matrix products (Fe -> H, H -> W)."""
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout

    return 2 * (Fe * H + H * tp_layout(irreps_in, irreps_out, irreps_sh).weight_numel)


def bounds(nbytes_moved: int, flops: int, mm: int) -> dict:
    """The least time of a call, in ms, two ways: ``fp32``, every flop at
    the float32 CUDA-core peak; ``tc``, the matrix products (``mm`` of the
    flops) at the 3xTF32 tensor-core rate (three TF32 products at 495
    TFLOP/s) and the rest at the float32 peak. Each against the bytes (each
    input read once, each output written once) at 3.35 TB/s; ``by``: what
    sets the tensor-core bound."""
    b = nbytes_moved / PEAK_BYTES * 1e3
    ops_fp32 = flops / PEAK_FP32_FLOPS * 1e3
    ops_tc = (TC_PRODUCTS * mm / PEAK_TF32_FLOPS + (flops - mm) / PEAK_FP32_FLOPS) * 1e3
    return dict(bytes=b, fp32=max(b, ops_fp32), tc=max(b, ops_tc), by="operations" if ops_tc >= b else "bytes")


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
    """(flops, matrix-product flops, tag) of one fused_tpconv_rec (13
    arguments) or fused_tpconv_rec_g (14, with the harmonics) call on this
    data."""
    node, _, nbr, emb, _, mask, _, _, w2, _ = args[:10]
    ir_in, ir_sh, ir_out, ns = (args[10], SH1, *args[11:]) if len(args) == 13 else args[10:]
    B, N, K = nbr.shape
    H = w2.shape[0]
    rows = int(mask.any(-1).sum()) + int(used_rows(nbr, mask, N).sum())
    edges, nodes = int(mask.sum()), rows * node_flops(ns, H)
    flops = edges * flops_per_edge(ir_in, ir_out, emb.shape[-1], H, ir_sh) + nodes
    mm = edges * mm_flops_per_edge(ir_in, ir_out, emb.shape[-1], H, ir_sh) + nodes
    return flops, mm, f"B={B} N={N} K={K} D {node.shape[-1]}->{tp_dout(ir_in, ir_out, ir_sh)}"


def pb_work(args):
    lig, _, pair_emb, pair_mask, bsrc, bdst, _, bmask, _, _, w2, _, ir_in, ir_out, ns = args
    B, L, _ = lig.shape
    H = w2.shape[0]
    recv = pair_mask.any(-1).reshape(-1) | used_rows(bsrc, bmask, L)
    send = pair_mask.any(-2).reshape(-1) | used_rows(bdst, bmask, L)
    edges, nodes = int(pair_mask.sum()) + int(bmask.sum()), int(recv.sum() + send.sum()) * node_flops(ns, H)
    flops = edges * flops_per_edge(ir_in, ir_out, pair_emb.shape[-1], H) + nodes
    mm = edges * mm_flops_per_edge(ir_in, ir_out, pair_emb.shape[-1], H) + nodes
    return flops, mm, f"B={B} L={L} E={bsrc.shape[1]} D {lig.shape[-1]}->{tp_dout(ir_in, ir_out)}"


def cross_work(args):
    lig, _, rec, _, idx, emb, mask, _, _, w2, _, w1_r = args[:12]
    ir_in, ir_out, ns = args[-3:]
    B, L, K = idx.shape
    N, H = rec.shape[1], w2.shape[0]
    dirs = 1 if w1_r is None else 2  # the reverse direction has its own weights: all its work again
    rows = int(mask.any(-1).sum()) + int(used_rows(idx, mask, N).sum())
    edges, nodes = int(mask.sum()), rows * node_flops(ns, H)
    flops = dirs * (edges * flops_per_edge(ir_in, ir_out, emb.shape[-1], H) + nodes)
    mm = dirs * (edges * mm_flops_per_edge(ir_in, ir_out, emb.shape[-1], H) + nodes)
    return flops, mm, (f"B={B} L={L} N={N} K={K} D {lig.shape[-1]}->{tp_dout(ir_in, ir_out)}"
                       f"{'' if dirs == 2 else ', no reverse'}")


def cross_g_work(args):
    """(flops, matrix-product flops, tag) of one fused_tpconv_cross_g call:
    one direction."""
    recv, _, src, _, idx, emb, mask, _, _, w2, _, ir_in, ir_sh, ir_out, ns = args
    B, L, K = idx.shape
    N, H = src.shape[1], w2.shape[0]
    rows = int(mask.any(-1).sum()) + int(used_rows(idx, mask, N).sum())
    edges, nodes = int(mask.sum()), rows * node_flops(ns, H)
    flops = edges * flops_per_edge(ir_in, ir_out, emb.shape[-1], H, ir_sh) + nodes
    mm = edges * mm_flops_per_edge(ir_in, ir_out, emb.shape[-1], H, ir_sh) + nodes
    return flops, mm, f"B={B} L={L} N={N} K={K} D {recv.shape[-1]}->{tp_dout(ir_in, ir_out, ir_sh)}"


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


def sample_kernels() -> dict:
    """The score model's kernels with their plain versions, work and the
    TPU kernels they replace, as ``replay`` takes them."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_lig, tpconv_rec

    return {
        "tpconv_rec": (tpconv_rec.fused_tpconv_rec, tpconv_rec.tpconv_rec_plain, rec_work,
                       "confidence_bootstrapping_tpu/ops/pallas/tpconv_rec.py:154"),
        "tpconv_pb": (tpconv_lig.fused_tpconv_pb, tpconv_lig.tpconv_pb_plain, pb_work,
                      "confidence_bootstrapping_tpu/ops/pallas/tpconv_lig.py:207"),
        "tpconv_cross_rev": (tpconv_lig.fused_tpconv_cross_rev, tpconv_lig.tpconv_cross_rev_plain, cross_work,
                             "confidence_bootstrapping_tpu/ops/pallas/tpconv_lig.py:389"),
    }


def replay_sample(model, run, what: str) -> list:
    """One sample run with the wrappers recorded, its calls checked against
    the launches the config implies, then every call replayed through the
    kernel and its plain version (``replay``; rec and pb bit for bit across
    two launches). Returns ``replay``'s rows."""
    import torch

    calls = record_calls(run)
    torch.cuda.synchronize()
    counts = {name: len(calls[name]) for name in KERNELS}
    want = {name: n for name, n in expected_launches(model, STEPS).items() if name in KERNELS}
    print(f"recorded {what}: calls {counts}, expected from the config {want}", flush=True)
    if counts != want:
        fail(f"the recorded {what} did not run every TP-conv through its wrapper")
    rows = replay(calls, sample_kernels(), bitwise=("tpconv_rec", "tpconv_pb"))
    del calls
    torch.cuda.empty_cache()
    return rows


def kernel_phase(model, run) -> list:
    """Phase 3: every kernel against its plain version on what the main path
    gives it. One sample runs with the wrappers recorded; every call is
    replayed through the kernel and its plain version, both timed, with its
    bound from its own data. Printed per shape (receptor embedding at B=1,
    each phase's N and cross K, with and without reverse weights) and per
    kernel as means over the sample's launches."""
    return replay_sample(model, run, "sample")


def replay(calls: dict, kernels: dict, rtols: dict = None, bitwise=()) -> list:
    """Replay every recorded call through its kernel and its plain version:
    error against the stated tolerance, both timed, both bounds (``bounds``)
    from the call's own data. Prints per shape and as means over the calls;
    returns one JSON row per kernel (without ``launches``). ``rtols``: per
    kernel, a tolerance per output (default KERNEL_RTOL for each), each
    output held to it times max(1, max |its plain value|). The kernels named
    in ``bitwise`` must give the same bits on a second launch."""
    import torch

    def outputs(o):
        return [t for t in (o if isinstance(o, tuple) else (o,)) if t is not None]

    rows = []
    for name, (fn, plain, work, replaces) in kernels.items():
        shapes = {}  # tag -> per-call measurements
        for args, kwargs in calls[name]:
            got, ref = outputs(fn(*args, **kwargs)), outputs(plain(*args))
            torch.cuda.synchronize()
            if name in bitwise and not all(torch.equal(a, b) for a, b in zip(got, outputs(fn(*args, **kwargs)))):
                fail(f"kernel {name} is not bit for bit across two launches on the same inputs")
            errs = [(g - w).abs().max().item() for g, w in zip(got, ref)]
            scales = [w.abs().max().item() for w in ref]
            tols = (rtols or {}).get(name, (KERNEL_RTOL,) * len(ref))
            err, scale = max(errs), max(scales)
            flops, mm, tag = work(args)
            b = bounds(nbytes(*(a for a in args if torch.is_tensor(a)), *got), flops, mm)
            shapes.setdefault(tag, []).append(dict(
                err=err, rel=err / max(scale, 1e-30),
                ok=all(e <= t * max(1.0, sc) for e, t, sc in zip(errs, tols, scales)),
                ms=cuda_time(lambda: fn(*args, **kwargs), reps=5, warmup=1),
                plain_ms=cuda_time(lambda: plain(*args), reps=2, warmup=0),
                bound=b["tc"], bound_fp32=b["fp32"], bound_bytes=b["bytes"], flops=flops, mm=mm))
        every = [m for ms in shapes.values() for m in ms]
        for tag, ms in list(shapes.items()) + [("all", every)]:
            mean = {k: float(np.mean([m[k] for m in ms]))
                    for k in ("ms", "plain_ms", "bound", "bound_fp32", "bound_bytes", "flops", "mm")}
            ok = all(m["ok"] for m in ms)
            by = "operations" if mean["bound"] > mean["bound_bytes"] else "bytes"
            print(f"kernel {name} [{tag}], {len(ms)} calls: max_abs_err {max(m['err'] for m in ms):.3g} (max rel "
                  f"{max(m['rel'] for m in ms):.3g}; tolerance {(rtols or {}).get(name, KERNEL_RTOL)} x max(1, max |plain|)) "
                  f"{'ok' if ok else 'MISMATCH'}; mean kernel {mean['ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms, "
                  f"bound {mean['bound']:.4f} ms tensor cores ({by}), {mean['bound_fp32']:.4f} ms float32 "
                  f"({mean['flops']:.4g} flops, {mean['mm']:.4g} in the matrix products); per run "
                  f"{mean['ms'] * len(ms):.2f} ms", flush=True)
            if not ok:
                fail(f"kernel {name} [{tag}] disagrees with its plain version")
        # ``mean`` and ``by`` now hold the means over every call ("all", the last tag)
        rows.append(dict(name=name, route="cuda", source=f"confidence_bootstrapping_tpu_torch/csrc/{name}.cu",
                         replaces=replaces, max_abs_err=max(m["err"] for m in every), ms=mean["ms"],
                         plain_ms=mean["plain_ms"], bound_ms=mean["bound"], bound_fp32_ms=mean["bound_fp32"],
                         bound_by=by, library_ms=None))
        torch.cuda.synchronize()
    return rows


def host_complex(lm_dim: int, all_atoms: bool = False):
    """1a0q from the committed featurization cache, with random ESM-sized
    receptor features as bench.py makes them; with ``all_atoms``, seeded
    receptor atoms too (``receptor_atoms``) in the all-atom bucket. ->
    (padded arrays, the complex, its molecule)."""
    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_cache, pad_complex, pick_bucket

    hc, mol = load_host_cache(CACHE_PKL)
    hc = hc._replace(rec_lm=np.random.RandomState(0).randn(len(hc.rec_f), lm_dim).astype(np.float32))
    if all_atoms:
        hc = hc._replace(**receptor_atoms(hc.rec_f, hc.rec_pos, N_ATOMS))
    bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                         n_atoms=N_ATOMS if all_atoms else 0, all_atoms=all_atoms)
    return pad_complex(hc, bucket, lm_dim=lm_dim), hc, mol


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
    padded = host_complex(LM_DIM)[0]
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
    trunk layer on cross_rev, and every trunk layer but the last on rec; the
    composed route's kernels (rows 4-6) never."""
    n_emb, n_trunk = len(model.rec_emb_layers), len(model.conv_layers)
    return {"tpconv_rec": n_emb + (n_trunk - 1) * steps,
            "tpconv_pb": (len(model.lig_emb_layers) + n_trunk) * steps,
            "tpconv_cross_rev": n_trunk * steps, "tpconv_cross": 0, "tpconv_nbr": 0, "tpconv_msgs": 0}


def score_counters() -> dict:
    """name -> the wrapper that counts the inference launches of a score-model
    TP-conv kernel (rows 1-6)."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_lig, tpconv_rec, tpconv_v3

    return {"tpconv_rec": tpconv_rec.fused_tpconv_rec, "tpconv_pb": tpconv_lig.fused_tpconv_pb,
            "tpconv_cross_rev": tpconv_lig.fused_tpconv_cross_rev, "tpconv_cross": tpconv_rec.fused_tpconv_cross,
            "tpconv_nbr": tpconv_v3.fused_tpconv_nbr, "tpconv_msgs": tpconv_v3.fused_tpconv_msgs}


def counted(run) -> tuple:
    """(run()'s result, the launches of every score-model kernel in it): the
    counts are set to 0 just before and read just after, synchronised."""
    import torch

    counters = score_counters()
    for fn in counters.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in counters.items()}


def sample_phase(model, b0, run):
    """Phase 5: the main path, timed. Returns (the kernel launches of the
    timed sample, its final ligand positions [B, L, 3])."""
    import torch

    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    print(f"sample warm-up: {time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    (final, _), launches = counted(run)
    secs = time.perf_counter() - t0

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
    (the replay's JSON rows, the launches of the timed forward, (the
    confidence model, its B_POSES batch of 1a0q) for phase 8's rerank)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import confidence_model_config
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel, compact_crop
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

    cfg = confidence_model_config(lm_embedding_dim=LM_DIM)
    padded, hc, _ = host_complex(LM_DIM, all_atoms=True)
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
    rows = replay(calls, kernels, bitwise=("tpconv_rec_g",))
    profile_run(run, secs * 1e3)
    return rows, launches, (model, batch)


# ---------------------------------------------------------------------------- phase 7: training


TRAIN_STEPS, EVAL_DRAWS = 5, 8  # the timed steps' batch is TrainConfig().batch_size
SUM_RTOL = 1e-3  # weight gradients: sums over every edge of a call, in another order than the plain version's
RELU_GUARD = 1e-5  # a hidden pre-activation within this of zero, relative to sum |z w1| + |b1|, is "at the ReLU"
TRAIN_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "tpconv_edge": ("csrc/tpconv_edge.cu", "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:303"),
    "tpconv_rec_dm": ("csrc/tpconv_rec.cu", "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:457"),
    "tpconv_bwd": ("csrc/tpconv_bwd.cu", "confidence_bootstrapping_tpu/ops/pallas/tpconv_bwd.py:151"),
}
TRAIN_OPS = {  # the autograd ops over them
    "fused_tpconv_train": "confidence_bootstrapping_tpu/ops/pallas/tpconv_train.py:266",
    "fused_tpconv_rec_train": "confidence_bootstrapping_tpu/ops/pallas/tpconv_train.py:380",
}


def expected_train_launches(model) -> dict:
    """Kernel launches of one training step (the JAX package's training
    routing): per ligand conv (embedding and trunk) the pairs (K-sum) and the
    bonds (per edge), per trunk layer the ligand <- receptor lists (K-sum) and
    per trunk layer but the last the receptor <- ligand lists (per edge), the
    center and the torsion conv (per edge) on the edge-list kernel; every
    receptor kNN group (embedding, and trunk but the last) on rec with the
    dropout mask; one edge backward per op."""
    P, C = len(model.lig_emb_layers), len(model.conv_layers)
    edge = 2 * (P + C) + C + (C - 1) + 1 + (0 if model.cfg.no_torsion else 1)
    rec = len(model.rec_emb_layers) + C - 1
    return {"tpconv_edge": edge, "tpconv_rec_dm": rec, "tpconv_bwd": edge + rec}


def train_counters() -> dict:
    """name -> (wrapper, the attribute that counts its training kernel's
    launches): rec's dropout-mask variant is counted apart from inference."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_edge, tpconv_rec

    return {"tpconv_edge": (tpconv_edge.fused_tpconv_edge, "launches"),
            "tpconv_rec_dm": (tpconv_rec.fused_tpconv_rec, "dm_launches"),
            "tpconv_bwd": (tpconv_bwd.edge_bwd, "launches")}


def bwd_flops_per_edge(irreps_in: str, irreps_out: str, F: int, H: int, irreps_sh: str) -> int:
    """One valid edge's backward: the MLP and TP-weight recompute, the CG
    contributions, d_w and d_X (the TP contraction twice), dh, d_z, the
    sender and harmonic gradients, and its share of dW1 and dW2."""
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout
    from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

    lay = tp_layout(irreps_in, irreps_out, irreps_sh)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    contract = sum(g.fan_in * g.w_shape[1] * tp.irreps_out[g.out_index].ir.dim for g in tp.groups)
    cg = int(sum(r[1] * r[3] for r in lay.xtab))
    return 2 * (3 * F * H + 3 * H * lay.weight_numel + 2 * contract + 3 * cg)


def bwd_mm_flops_per_edge(irreps_in: str, irreps_out: str, F: int, H: int, irreps_sh: str) -> int:
    """The matrix products of ``bwd_flops_per_edge``: the MLP recompute, dh,
    d_z and the edge's share of dW1 and dW2."""
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import tp_layout

    return 2 * (3 * F * H + 3 * H * tp_layout(irreps_in, irreps_out, irreps_sh).weight_numel)


def edge_work(args):
    attr, _, sh, mask, _, _, w2, _, ir_in, ir_sh, ir_out, dmask, sum_k = args
    M, K, F = attr.shape
    edges = int(mask.sum())
    flops = edges * flops_per_edge(ir_in, ir_out, F, w2.shape[0], ir_sh)
    mm = edges * mm_flops_per_edge(ir_in, ir_out, F, w2.shape[0], ir_sh)
    return flops, mm, (f"M={M} K={K} D {attr.shape[-1]}/{tp_dout(ir_in, ir_out, ir_sh)} sh {sh.shape[-1]} "
                       f"{'K-sum' if sum_k else 'per edge'}{', dropout' if dmask is not None else ''}")


def bwd_work(args):
    attr, _, sh, g, _, _, _, w2, _, ir_in, ir_sh, ir_out = args
    T, F = attr.shape
    valid = int((g != 0).any(-1).sum())  # masked edges carry a zero cotangent: no work
    flops = valid * bwd_flops_per_edge(ir_in, ir_out, F, w2.shape[0], ir_sh)
    mm = valid * bwd_mm_flops_per_edge(ir_in, ir_out, F, w2.shape[0], ir_sh)
    return flops, mm, f"T={T} valid={valid} F={F} sh {sh.shape[-1]} -> {g.shape[-1]}"


def near_relu_boundary(z, w1, b1):
    """[...] bool: the edges (MLP inputs z [..., F]) with a hidden
    pre-activation within rounding of zero. There the kernel and the plain
    version, summing in other orders, may take different sides of the ReLU,
    and a gradient then differs by a whole term; the gradient checks leave
    these edges out (both sides of a comparison get the same inputs)."""
    import torch

    with torch.no_grad():
        hpre = z @ w1 + b1
        return (hpre.abs() < RELU_GUARD * (z.abs() @ w1.abs() + b1.abs())).any(-1)


def record_train_calls(run) -> dict:
    """Run ``run()`` with the training kernels' wrappers, as the autograd
    ops call them, wrapped to keep every call's inputs in the plain
    versions' positional order; and the autograd ops, as the conv layers
    call them."""
    from confidence_bootstrapping_tpu_torch.models import layers
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_train as tt

    calls = {name: [] for name in list(TRAIN_KERNELS) + list(TRAIN_OPS)}
    orig = {"edge": tt.fused_tpconv_edge, "rec": tt.fused_tpconv_rec, "bwd": tt.edge_bwd,
            "op": layers.fused_tpconv_train, "rec_op": layers.fused_tpconv_rec_train}

    def edge(*a, dmask=None, sum_k=True, packed=None):
        calls["tpconv_edge"].append((a + (dmask, sum_k), {}))
        return orig["edge"](*a, dmask=dmask, sum_k=sum_k, packed=packed)

    def rec(*a, packed=None, dmask=None):
        calls["tpconv_rec_dm"].append((a + (dmask,), {}))
        return orig["rec"](*a, packed=packed, dmask=dmask)

    def bwd(*a):
        calls["tpconv_bwd"].append((a, {}))
        return orig["bwd"](*a)

    def op(*a, **kw):
        calls["fused_tpconv_train"].append((a, kw))
        return orig["op"](*a, **kw)

    def rec_op(*a, **kw):
        calls["fused_tpconv_rec_train"].append((a, kw))
        return orig["rec_op"](*a, **kw)

    try:
        tt.fused_tpconv_edge, tt.fused_tpconv_rec, tt.edge_bwd = edge, rec, bwd
        layers.fused_tpconv_train, layers.fused_tpconv_rec_train = op, rec_op
        run()
    finally:
        tt.fused_tpconv_edge, tt.fused_tpconv_rec, tt.edge_bwd = orig["edge"], orig["rec"], orig["bwd"]
        layers.fused_tpconv_train, layers.fused_tpconv_rec_train = orig["op"], orig["rec_op"]
    return calls


def replay_train_ops(calls: dict) -> list:
    """Rows 11 and 12: every recorded call of the two autograd ops, forward
    and backward against a random cotangent, through the kernels and through
    autograd of the plain composition on the card: outputs and every
    gradient against the stated tolerances, both timed. Bound: the sum of
    the call's forward and backward bounds."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge, tpconv_rec, tpconv_train as tt
    from confidence_bootstrapping_tpu_torch.ops.graph_builders import gather_nodes

    rows = []
    for name, replaces in TRAIN_OPS.items():
        ms = []
        for args, kw in calls[name]:
            args = list(args)
            if name == "fused_tpconv_train":
                near, mask0 = near_relu_boundary(args[0], args[4], args[5]), args[3]
                args[3] = mask0 & ~near
                grad_at = [0, 1, 2, 4, 5, 6, 7]  # edge_attr, sender, sh, w1, b1, w2, b2
                kernel = lambda a: tt.fused_tpconv_train(*a, dmask=kw.get("dmask"), sum_k=kw["sum_k"])
                plain = lambda a: tpconv_edge.tpconv_edge_plain(*a, kw.get("dmask"), kw["sum_k"])
                attr, mask = args[0], args[3]
                H, ir = args[6].shape[0], args[8:11]
                fwd_flops = int(mask.sum()) * flops_per_edge(ir[0], ir[2], attr.shape[-1], H, ir[1])
                bwd_flops = int(mask.sum()) * bwd_flops_per_edge(ir[0], ir[2], attr.shape[-1], H, ir[1])
                mm = int(mask.sum()) * (mm_flops_per_edge(ir[0], ir[2], attr.shape[-1], H, ir[1])
                                        + bwd_mm_flops_per_edge(ir[0], ir[2], attr.shape[-1], H, ir[1]))
            else:
                node, nbr, emb, sig, ns = args[0], args[2], args[3], args[4], args[13]
                z = torch.cat([emb + sig[:, None, None, :], node[:, :, None, :ns].expand(emb.shape[:-1] + (ns,)),
                               gather_nodes(node, nbr)[..., :ns]], dim=-1)
                near, mask0 = near_relu_boundary(z, args[6], args[7]), args[5]
                args[5] = mask0 & ~near
                grad_at = [0, 1, 3, 4, 6, 7, 8, 9]  # node_attr, pos, edge_emb, sig, w1, b1, w2, b2
                kernel = lambda a: tt.fused_tpconv_rec_train(*a, dmask=kw.get("dmask"))
                plain = lambda a: tpconv_rec.tpconv_rec_plain(*a[:10], a[10], a[12], a[13], kw.get("dmask"))
                mask, H = args[5], args[8].shape[0]
                ir = (args[10], args[11], args[12])
                F = args[3].shape[-1] + 2 * args[13]
                fwd_flops, fwd_mm, _ = rec_work(tuple(args[:10]) + (args[10], args[12], args[13]))
                bwd_flops = int(mask.sum()) * bwd_flops_per_edge(ir[0], ir[2], F, H, ir[1])
                mm = fwd_mm + int(mask.sum()) * bwd_mm_flops_per_edge(ir[0], ir[2], F, H, ir[1])
            leaves = [args[i].detach().clone().requires_grad_(True) for i in grad_at]
            a = list(args)
            for i, t in zip(grad_at, leaves):
                a[i] = t

            def fwd_bwd(f, cot=None):
                out = f(a)
                c = torch.ones_like(out) if cot is None else cot
                return (out, *torch.autograd.grad(out, leaves, c))

            cot = torch.randn(kernel(a).shape, device=mask.device)
            got, ref = fwd_bwd(kernel, cot), fwd_bwd(plain, cot)
            torch.cuda.synchronize()
            errs = [(g - w).abs().max().item() for g, w in zip(got, ref)]
            scales = [w.abs().max().item() for w in ref]
            n_edge = 1 + (2 if name == "fused_tpconv_rec_train" else 3)  # outputs held per edge/node at 2e-4
            ok = all(e <= (KERNEL_RTOL if i < n_edge else SUM_RTOL) * max(1.0, sc)
                     for i, (e, sc) in enumerate(zip(errs, scales)))
            b = bounds(nbytes(*(t for t in args if torch.is_tensor(t)), *got), fwd_flops + bwd_flops, mm)
            ms.append(dict(err=max(errs), ok=ok, bound=b["tc"], bound_fp32=b["fp32"], by=b["by"],
                           guarded=int((near & mask0).sum()), edges=int(mask0.sum()),
                           ms=cuda_time(lambda: fwd_bwd(kernel, cot), reps=3, warmup=1),
                           plain_ms=cuda_time(lambda: fwd_bwd(plain, cot), reps=1, warmup=0)))
            if not ok:
                fail(f"{name}: the autograd op through the kernels disagrees with autograd of the plain version "
                     f"(errors {errs})")
        mean = {k: float(np.mean([m[k] for m in ms])) for k in ("ms", "plain_ms", "bound", "bound_fp32")}
        print(f"op {name}, {len(ms)} calls (forward + backward): max_abs_err {max(m['err'] for m in ms):.3g} ok "
              f"({sum(m['guarded'] for m in ms)} of {sum(m['edges'] for m in ms)} edges at the ReLU left out); "
              f"mean {mean['ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms, bound {mean['bound']:.4f} ms tensor cores, "
              f"{mean['bound_fp32']:.4f} ms float32", flush=True)
        rows.append(dict(name=name, route="cuda", source="confidence_bootstrapping_tpu_torch/ops/cuda/tpconv_train.py",
                         replaces=replaces, max_abs_err=max(m["err"] for m in ms), ms=mean["ms"],
                         plain_ms=mean["plain_ms"], bound_ms=mean["bound"], bound_fp32_ms=mean["bound_fp32"],
                         bound_by=ms[0]["by"], library_ms=None))
    return rows


def replay_train_kernels(calls: dict) -> list:
    """The training kernels' recorded calls (``record_train_calls``) replayed
    through kernel and plain version; the edges at the ReLU
    (``near_relu_boundary``) get no cotangent in the backward's replay.
    Returns their JSON rows."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_edge, tpconv_rec

    guarded = 0
    for i, (a, kw) in enumerate(calls["tpconv_bwd"]):
        near = near_relu_boundary(a[0], a[5], a[6])
        guarded += int((near & (a[3] != 0).any(-1)).sum())
        calls["tpconv_bwd"][i] = (a[:3] + (a[3] * ~near[:, None],) + a[4:], kw)
    print(f"edge backward replay: {guarded} edges at the ReLU left out", flush=True)
    kernels = {
        "tpconv_edge": (lambda *a: tpconv_edge.fused_tpconv_edge(*a[:11], dmask=a[11], sum_k=a[12]),
                        tpconv_edge.tpconv_edge_plain, edge_work, TRAIN_KERNELS["tpconv_edge"][1]),
        "tpconv_rec_dm": (lambda *a: tpconv_rec.fused_tpconv_rec(*a[:13], dmask=a[13]), tpconv_rec.tpconv_rec_plain,
                          lambda a: rec_work(a[:13]), TRAIN_KERNELS["tpconv_rec_dm"][1]),
        "tpconv_bwd": (tpconv_bwd.edge_bwd, tpconv_bwd.edge_bwd_plain, bwd_work, TRAIN_KERNELS["tpconv_bwd"][1]),
    }
    with torch.no_grad():
        rows = replay(calls, kernels, rtols={"tpconv_bwd": (KERNEL_RTOL,) * 3 + (SUM_RTOL,) * 4})
    for r in rows:
        r["source"] = "confidence_bootstrapping_tpu_torch/" + TRAIN_KERNELS[r["name"]][0]
    return rows


def train_phase(dev) -> tuple:
    """Phase 7: training steps of the full-width score model (see the module
    docstring). Returns (JSON rows, launches per step by kernel)."""
    import dataclasses

    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.train import diffusion, losses, train_loop

    padded = host_complex(LM_DIM)[0]
    tcfg = TrainConfig()

    # the card against the CPU: one step's loss, gradients and batch statistics at dropout 0
    cfg0 = ScoreModelConfig(lm_embedding_dim=LM_DIM, dropout=0.0)
    draws = None
    res = []
    for device in (dev, torch.device("cpu")):  # the card first: it builds the so3/torus tables
        model = TensorProductScoreModel(cfg0, device=device, seed=0)
        model.requires_grad_(True)
        batch = replicate_complex(padded, 2, device=device)
        if draws is None:
            draws = diffusion.draw_noise(batch, cfg0.sigma, tcfg, torch.Generator(device=device).manual_seed(5))
        noised, targets = diffusion.apply_draws(batch, diffusion.NoiseDraws(*(d.to(device) for d in draws)),
                                                cfg0.sigma)
        out = model(noised, deterministic=False, use_running_average=False)
        lb = losses.score_matching_loss(out.tr_pred, out.rot_pred, out.tor_pred, targets, noised, cfg0.sigma,
                                        tcfg.tr_weight, tcfg.rot_weight, tcfg.tor_weight)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(lb.loss, [p for _, p in model.named_parameters()], allow_unused=True)
        res.append((lb.loss.detach().cpu(), {n: (torch.zeros(()) if g is None else g.cpu()) for n, g in zip(names, grads)},
                    {n: b.cpu() for n, b in model.named_buffers()}))
    (lg, gg, bg), (lc, gc, bc) = res
    checks = [("loss", lg, lc)] + [(f"grad {n}", gg[n], gc[n]) for n in gc] + [(f"stat {n}", bg[n], bc[n]) for n in bc]
    checks = [c for c in checks if c[2].numel()]  # batch norms of outputs with no scalars have empty statistics
    worst = max(((g - w).abs().max().item() / (MODEL_RTOL * max(1.0, w.abs().max().item())), n) for n, g, w in checks)
    print(f"training step card vs CPU (B=2, dropout 0): loss {lg.item():.6f} vs {lc.item():.6f}; "
          f"{len(gc)} gradients and {len(bc)} batch statistics; worst error {worst[0]:.3g} of its tolerance "
          f"({MODEL_RTOL} x max(1, max |cpu|)) at {worst[1]}", flush=True)
    if not (worst[0] <= 1.0 and torch.isfinite(lg)):
        fail("training step: the card disagrees with the CPU")

    # timed steps at TrainConfig().batch_size (16) with dropout
    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM)
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    state = train_loop.init_train_state(model, tcfg)
    batch = replicate_complex(padded, tcfg.batch_size, device=dev)
    step = train_loop.make_train_step(cfg, tcfg)
    evaluate = train_loop.make_eval_step(cfg, tcfg, use_running_average=False)

    def eval_loss():
        return float(np.mean([evaluate(state, batch, torch.Generator(device=dev).manual_seed(100 + i))["loss"].item()
                              for i in range(EVAL_DRAWS)]))

    print(f"training: full-width score model (ns={cfg.ns}, nv={cfg.nv}, {cfg.num_prot_emb_layers}+"
          f"{cfg.num_prot_emb_layers} embedding and {cfg.num_conv_layers} trunk layers, lm_dim {LM_DIM}, dropout "
          f"{cfg.dropout}), 1a0q x {tcfg.batch_size}, TrainConfig() (lr {tcfg.lr}, Adam, EMA {tcfg.ema_rate})",
          flush=True)
    eval_before = eval_loss()
    gen = torch.Generator(device=dev).manual_seed(11)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = train_loop.batch_stats(model)
    t0 = time.perf_counter()
    step(state, batch, gen)  # warm-up
    torch.cuda.synchronize()
    print(f"training warm-up step: {time.perf_counter() - t0:.3f} s", flush=True)
    counters = train_counters()
    walls, parts, loss_vals, launches = [], [], [], []
    for _ in range(TRAIN_STEPS):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, batch, gen, mark)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts.append((start.elapsed_time(events["forward"]), events["forward"].elapsed_time(events["backward"]),
                      events["backward"].elapsed_time(events["update"])))
        loss_vals.append(metrics["loss"].item())
        launches.append({name: getattr(fn, attr) for name, (fn, attr) in counters.items()})
    med = float(np.median(walls))
    fwd, bwd, upd = (float(np.median([p[i] for p in parts])) for i in range(3))
    print(f"training step: median {med:.2f} ms over {TRAIN_STEPS} steps ({', '.join(f'{w:.1f}' for w in walls)}), "
          f"{tcfg.batch_size / med * 1e3:.3f} training poses/s; CUDA events: noise + forward {fwd:.2f} ms, backward "
          f"{bwd:.2f} ms, optimiser + EMA {upd:.2f} ms; losses {', '.join(f'{v:.4f}' for v in loss_vals)}", flush=True)
    want = expected_train_launches(model)
    print(f"launches per training step: {launches[-1]}; expected from the config: {want}", flush=True)
    if any(n != want for n in launches):
        fail("a training step did not run every TP-conv through its kernels")
    moved = max((p.detach() - params0[n]).abs().max().item() for n, p in model.named_parameters() if p.numel())
    smoved = max((b - stats0[n]).abs().max().item() for n, b in model.named_buffers() if b.numel())
    print(f"after {TRAIN_STEPS + 1} steps: parameters moved up to {moved:.3g}, batch statistics up to {smoved:.3g}, "
          f"EMA step {state.step}", flush=True)
    if not (all(np.isfinite(loss_vals)) and moved > 0 and smoved > 0):
        fail("training: a loss is not finite, or the parameters or batch statistics did not move")
    eval_after = eval_loss()
    print(f"eval loss (batch statistics, {EVAL_DRAWS} fixed draws, a measurement): {eval_before:.4f} before, "
          f"{eval_after:.4f} after the timed steps", flush=True)

    # one step's calls, replayed through kernel and plain version
    calls = record_train_calls(lambda: step(state, batch, gen))
    torch.cuda.synchronize()
    rows = replay_train_kernels(calls)
    rows += replay_train_ops(calls)
    profile_run(lambda: step(state, batch, gen), med)
    per_step = dict(launches[-1])
    per_step.update({"fused_tpconv_train": len(calls["fused_tpconv_train"]),
                     "fused_tpconv_rec_train": len(calls["fused_tpconv_rec_train"])})
    return rows, per_step


# ---------------------------------------------------------------------------- phase 8: the evaluator's path


EVAL_CAP = 100  # infer --cross_cap 100: pinned, off the 16-grid, at every receptor bucket of the plan
B_8B, STEPS_8B = 8, 3  # phase 8b's card-against-CPU sample: the ligand at its own 23 atoms
RMSD_ATOL = 1e-5  # symmetry RMSD on the card against the same function on the CPU, in A
EVAL_REPLACES = {
    "tpconv_cross": "confidence_bootstrapping_tpu/ops/pallas/tpconv_rec.py:328",
    "tpconv_nbr": "confidence_bootstrapping_tpu/ops/pallas/tpconv_v3.py:420",
    "tpconv_msgs": "confidence_bootstrapping_tpu/ops/pallas/tpconv_v3.py:430",
}
V1_REPLACES = "confidence_bootstrapping_tpu/ops/pallas/tpconv.py:405"


def expected_composed_launches(model, steps: int, pairs_composed: bool) -> dict:
    """Kernel launches of one shared-receptor sample whose cross list's K is
    not a multiple of 16: per step every trunk layer's ligand <- receptor
    lists on row 4 (``tpconv_cross``) and every trunk layer but the last's
    receptor <- ligand lists on row 6 (``tpconv_msgs``), none on cross_rev;
    the ligand pairs on pb, or with ``pairs_composed`` (L % 8 != 0) on row 5
    (``tpconv_nbr``); the receptor groups on rec as in phase 5."""
    n_lig = (len(model.lig_emb_layers) + len(model.conv_layers)) * steps
    want = expected_launches(model, steps)
    want.update(tpconv_cross_rev=0, tpconv_cross=len(model.conv_layers) * steps,
                tpconv_msgs=(len(model.conv_layers) - 1) * steps, tpconv_pb=0 if pairs_composed else n_lig,
                tpconv_nbr=n_lig if pairs_composed else 0)
    return want


def edge_list_work(sum_k: bool):
    """(flops, matrix-product flops, tag) of one row-5 (sum_k) or row-6
    call (10 positional arguments, the lmax=1 harmonics)."""
    return lambda a: edge_work(tuple(a[:8]) + (a[8], SH1, a[9], None, sum_k))


def eval_kernels() -> dict:
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_rec, tpconv_v3

    return {
        "tpconv_cross": (tpconv_rec.fused_tpconv_cross, tpconv_rec.tpconv_cross_plain,
                         lambda a: cross_g_work(tuple(a[:12]) + (SH1,) + tuple(a[12:])), EVAL_REPLACES["tpconv_cross"]),
        "tpconv_nbr": (tpconv_v3.fused_tpconv_nbr, tpconv_v3.tpconv_nbr_plain, edge_list_work(True),
                       EVAL_REPLACES["tpconv_nbr"]),
        "tpconv_msgs": (tpconv_v3.fused_tpconv_msgs, tpconv_v3.tpconv_msgs_plain, edge_list_work(False),
                        EVAL_REPLACES["tpconv_msgs"]),
    }


def eval_phase(dev, rerank) -> tuple:
    """Phase 8: the evaluator's per-complex path with a pinned cross cap
    (``cli/infer.py:355-571`` for one complex): the full-width score model
    with ``cross_cap=100, cross_cap_frac=0``, the phase plan from
    ``derive_phase_plan``, the cap telemetry, a warm and a timed B=32 20-step
    sample (launches against the config: rows 4 and 6 instead of cross_rev),
    the rerank with phase 6's confidence model, symmetry RMSDs against the
    crystal pose, centroid and self distances, and the metrics dictionary.
    Returns (the launches of the timed sample, every row-4/6 call of one
    more sample)."""
    import dataclasses

    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.eval import metrics, rmsd
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import (cross_overflow_stats, randomize_position, sample,
                                                                     score_confidence, with_derived_plan)

    cfg = dataclasses.replace(ScoreModelConfig(lm_embedding_dim=LM_DIM), cross_cap=EVAL_CAP, cross_cap_frac=0.0)
    padded, hc, mol = host_complex(LM_DIM)
    scfg = with_derived_plan(cfg, SamplerConfig(inference_steps=STEPS), padded["rec_pos"], padded["rec_mask"])
    N = padded["rec_pos"].shape[0]
    caps = {n: cfg.effective_cross_cap(n) for n in (N,) + scfg.rec_phase_caps}
    print(f"evaluator path: cross_cap {cfg.cross_cap} pinned (frac {cfg.cross_cap_frac}); derived plan steps "
          f"{scfg.rec_phase_steps} caps {scfg.rec_phase_caps}; cross K by receptor bucket {caps}", flush=True)
    if not scfg.rec_phase_steps or any(k % 16 == 0 for k in caps.values()):
        fail("the evaluator path needs a derived plan and a cross K off the 16-grid at every bucket")
    stats = cross_overflow_stats(replicate_complex(padded, 1, device=dev), cfg)
    print("cross-cap telemetry: " + ", ".join(f"{k} {v:.5f}" for k, v in stats.items()), flush=True)

    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    batch = replicate_complex(padded, B_POSES, device=dev)
    b0 = randomize_position(batch, torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    run = lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    print(f"evaluator sample warm-up: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    (final, _), launches = counted(run)
    t_sample = time.perf_counter() - t0
    want = expected_composed_launches(model, STEPS, pairs_composed=False)
    print(f"evaluator sample: {t_sample:.4f} s, {B_POSES / t_sample:.3f} poses/s; launches {launches}; expected from "
          f"the config {want}", flush=True)
    if launches != want:
        fail("the evaluator path did not run the composed cross route through rows 4 and 6")

    conf_model, conf_batch = rerank
    t0 = time.perf_counter()
    conf = score_confidence(conf_model, conf_batch, lig_pos=final.lig_pos).cpu().numpy()
    t_conf = time.perf_counter() - t0

    n = len(hc.lig_f)
    t0 = time.perf_counter()
    poses = final.lig_pos[:, :n]
    rmsds = rmsd.symmetry_rmsd(rmsd.ground_truth_poses(hc), poses, mol.atomic_nums, mol.bonds)
    host = poses.cpu().numpy()
    cent = np.linalg.norm(host.mean(axis=1) - hc.orig_lig_pos.mean(axis=0), axis=-1)
    self_d = np.asarray([metrics.min_self_distance(p, mol.bonds) for p in host])
    t_rmsd = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = metrics.performance_metrics(rmsds[None], cent[None], conf[None], self_d[None],
                                    np.asarray([t_sample + t_conf + t_rmsd]))
    t_metrics = time.perf_counter() - t0
    print(f"rerank {t_conf:.4f} s ({B_POSES / t_conf:.3f} poses/s), symmetry RMSD + centroid + self distances "
          f"{t_rmsd:.4f} s, metrics {t_metrics * 1e3:.3f} ms", flush=True)
    print(f"evaluator metrics (random weights: a measurement, not a gate): {json.dumps(m)}", flush=True)

    # the RMSD against its own definition: the same function on the CPU, the
    # crystal pose and one of its automorphic images at zero
    ref_cpu = rmsd.symmetry_rmsd(rmsd.ground_truth_poses(hc), host, mol.atomic_nums, mol.bonds)
    perm = next(p for p in rmsd.graph_automorphisms(mol.atomic_nums, mol.bonds) if (p != np.arange(n)).any())
    crystal = torch.as_tensor(np.stack([hc.orig_lig_pos, hc.orig_lig_pos[perm]]).astype(np.float32), device=dev)
    zero = rmsd.symmetry_rmsd(hc.orig_lig_pos, crystal, mol.atomic_nums, mol.bonds)
    plain = np.array([rmsd.plain_rmsd(hc.orig_lig_pos, p) for p in host])
    plain_image = rmsd.plain_rmsd(hc.orig_lig_pos, hc.orig_lig_pos[perm])
    err = float(np.abs(rmsds - ref_cpu).max())
    print(f"symmetry RMSD: {rmsds.min():.3f}-{rmsds.max():.3f} A over {len(rmsds)} poses (plain {plain.min():.3f}-"
          f"{plain.max():.3f}); card vs CPU max_abs_err {err:.3g} A (tolerance {RMSD_ATOL}); crystal pose and an "
          f"automorphic image {zero[0]:.3g}, {zero[1]:.3g} A (plain {plain_image:.3f})", flush=True)
    finite = all(np.isfinite(v) for v in m.values())
    if not (err <= RMSD_ATOL and np.all(rmsds <= plain + 1e-5) and zero.max() <= 1e-5 and conf.shape == (B_POSES,)
            and np.isfinite(conf).all() and finite and "filtered_rmsds_below_2" in m):
        fail("the evaluator's RMSDs, confidences or metrics are wrong")
    profile_run(run, t_sample * 1e3)
    calls = record_calls(run, ("tpconv_cross", "tpconv_msgs"))
    torch.cuda.synchronize()
    return launches, calls


def composed_pairs_phase(dev) -> tuple:
    """Phase 8b: row 5. The ligand padded to its own 23 atoms (L % 8 != 0:
    the pairs leave pb for row 5) and the cap pinned at 100. Card against
    CPU at a smaller depth: a 3-step probability-flow sample at B=8 with two
    compaction boundaries and a B=2 forward (the receptor <- ligand scatter
    sums with atomics on the card, in a run-dependent order: float32 ulps,
    well inside MODEL_RTOL and SAMPLE_ATOL). Then on the card alone phase
    8's sample at this bucket (B=32, 20 steps, the derived plan), warm, then
    timed with its launches against the config. Returns (that sample's
    launches, every row-5 call of one more)."""
    import dataclasses

    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import (load_host_complex, pad_complex, pick_bucket,
                                                                       replicate_complex)
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position, sample, with_derived_plan

    cfg = dataclasses.replace(ScoreModelConfig(lm_embedding_dim=LM_DIM), cross_cap=EVAL_CAP, cross_cap_frac=0.0)
    hc = load_host_complex(CACHE_PKL)
    hc = hc._replace(rec_lm=np.random.RandomState(0).randn(len(hc.rec_f), LM_DIM).astype(np.float32))
    bucket = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))._replace(L=len(hc.lig_f))
    padded = pad_complex(hc, bucket, lm_dim=LM_DIM)
    scfg = SamplerConfig(inference_steps=STEPS_8B, ode=True, rec_phase_steps=(1, 2), rec_phase_caps=(256, 128))
    noise = np.random.RandomState(3).randn(B_8B, *padded["lig_pos"].shape).astype(np.float32)
    pos = padded["lig_pos"][None] + noise * 2
    print(f"phase 8b: bucket {bucket}, B={B_8B}, {STEPS_8B}-step ODE sample, plan 1:256,2:128, cross cap {EVAL_CAP}",
          flush=True)
    res = []
    for device in (torch.device("cpu"), dev):  # the card's model last: the timed sample below runs it
        model = TensorProductScoreModel(cfg, device=device, seed=0)
        batch = replicate_complex(padded, B_8B, device=device).replace(lig_pos=torch.as_tensor(pos, device=device))
        fwd = model(batch.map(lambda a: a[:2]).set_time(0.5, 0.5, 0.5))
        final, _ = sample(model, batch, cfg, scfg, device=device)
        res.append(([t.cpu() for t in fwd], final.lig_pos.cpu()))
    (fc, pc), (fg, pg) = res
    for name, g, w in zip(("tr_pred", "rot_pred", "tor_pred"), fg, fc):
        err, peak = (g - w).abs().max().item(), w.abs().max().item()
        print(f"phase 8b forward {name}: max_abs_err {err:.3g} (max |cpu| {peak:.3g}, tolerance {MODEL_RTOL} x "
              f"max(1, max |cpu|))", flush=True)
        if not (err <= MODEL_RTOL * max(1.0, peak) and torch.isfinite(g).all()):
            fail(f"phase 8b forward {name}: the card disagrees with the CPU")
    err = (pg - pc).abs().max().item()
    moved = (pg - torch.as_tensor(pos)).abs().max().item()
    print(f"phase 8b sample: max_abs_err {err:.3g} A (tolerance {SAMPLE_ATOL} A), poses moved {moved:.3g} A",
          flush=True)
    if not (err <= SAMPLE_ATOL and moved > 0.1):
        fail("the phase 8b sample on the card disagrees with the CPU")

    scfg = with_derived_plan(cfg, SamplerConfig(inference_steps=STEPS), padded["rec_pos"], padded["rec_mask"])
    b0 = randomize_position(replicate_complex(padded, B_POSES, device=dev), torch.Generator(device=dev).manual_seed(0),
                            cfg.sigma.tr_sigma_max)
    run = lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (final, _), launches = counted(run)
    secs = time.perf_counter() - t0
    want = expected_composed_launches(model, STEPS, pairs_composed=True)
    print(f"phase 8b sample at L=23: B={B_POSES}, {STEPS} steps, plan steps {scfg.rec_phase_steps} caps "
          f"{scfg.rec_phase_caps}: {secs:.4f} s, {B_POSES / secs:.3f} poses/s; launches {launches}; expected from the "
          f"config {want}", flush=True)
    if launches != want:
        fail("phase 8b did not run the ligand pairs through row 5")
    if not torch.isfinite(final.lig_pos).all():
        fail("the phase 8b sample's poses are not finite")
    calls = record_calls(run, ("tpconv_nbr",))
    torch.cuda.synchronize()
    return launches, calls


def replay_v1(calls: dict) -> None:
    """Row 13: the v1 API on the first three recorded calls of rows 5 and 6
    against the plain versions, printed. It is an API over rows 5 and 6
    with no kernel and no launch counter of its own, and no main path calls
    it, so it has no row in the kernels line."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv, tpconv_v3

    errs, ms, plain_ms, tc, fp32 = [], [], [], [], []
    for name, v1, plain, sum_k in (("tpconv_nbr", tpconv.fused_tpconv_nbr, tpconv_v3.tpconv_nbr_plain, True),
                                   ("tpconv_msgs", tpconv.fused_tpconv_msgs, tpconv_v3.tpconv_msgs_plain, False)):
        for args, _ in calls[name][:3]:
            got, want = v1(*args), plain(*args)
            torch.cuda.synchronize()
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            if not err <= KERNEL_RTOL * max(1.0, scale):
                fail(f"the v1 API ({name}) disagrees with the plain version")
            flops, mm, _ = edge_list_work(sum_k)(args)
            b = bounds(nbytes(*(a for a in args if torch.is_tensor(a)), got), flops, mm)
            errs.append(err)
            ms.append(cuda_time(lambda: v1(*args), reps=5, warmup=1))
            plain_ms.append(cuda_time(lambda: plain(*args), reps=2, warmup=0))
            tc.append(b["tc"])
            fp32.append(b["fp32"])
    print(f"row 13 (v1 API, {V1_REPLACES}) on {len(errs)} recorded calls: max_abs_err {max(errs):.3g} ok; mean "
          f"{np.mean(ms):.4f} ms, plain {np.mean(plain_ms):.4f} ms, bound {np.mean(tc):.4f} ms tensor cores, "
          f"{np.mean(fp32):.4f} ms float32", flush=True)


# ---------------------------------------------------------------------------- phase 9: the wide ladder


WIDE_NS, WIDE_NV = 48, 10  # DiffDock's published score-model width: H = 3 ns = 144, above the tensor-core stage's 96
B_WIDE_CHECK, STEPS_WIDE_CHECK = 8, 3  # the card-against-CPU sample at the wide ladder


def ladder_pairs(ns: int, nv: int, reduce_pseudoscalars: bool = False) -> list:
    """The score model's (irreps_in, irreps_out) pairs: each embedding step,
    then the trunk's irreps to themselves (``ScoreModelConfig`` reduces the
    pseudoscalars to nv by default; the confidence model keeps ns)."""
    from confidence_bootstrapping_tpu_torch.models.score_model import get_irrep_seq

    seq = get_irrep_seq(ns, nv, reduce_pseudoscalars)
    return [(seq[min(i, 3)], seq[min(i + 1, 3)]) for i in range(4)]


def layout_check() -> int:
    """The host mirror of the engine's shared-memory layouts
    (``tpconv_common.engine_smem_bytes``, ``tpconv_bwd.bwd_smem_bytes``)
    against the bytes every kernel library exports, at the ns=32 and ns=48
    ladders and the confidence trunk, both stages and both chunk sizes; and
    ``engine_static_bytes`` against each library's kernels of every build it
    has (``cbt_static_smem_bytes``). Returns the number of comparisons."""
    import ctypes

    from confidence_bootstrapping_tpu_torch.ops.cuda import build, tpconv_bwd, tpconv_common as tc

    engine_libraries = [name for name in build.KERNEL_SOURCES if name != "tpconv_bwd"]
    cases = [(a, b, SH1, ns) for ns, nv in ((32, 6), (WIDE_NS, WIDE_NV)) for reduce in (False, True)
             for a, b in ladder_pairs(ns, nv, reduce)]
    cases += [(a, b, SH2, 24) for a, b in ladder_pairs(24, 6)]
    cases += [(ladder_pairs(ns, nv)[3][0], f"{ns}x0o + {ns}x0e", tc.TOR_SH_IRREPS, ns) for ns, nv in ((32, 6), (WIDE_NS, WIDE_NV))]
    n = 0
    for name in engine_libraries:
        static = build.load(name).cbt_static_smem_bytes
        static.argtypes, static.restype = [ctypes.c_int] * 2, ctypes.c_longlong
        builds = 0
        for on_tc, cm in ((True, tc.TM), (False, tc.TM), (False, tc.TM_WIDE)):
            got = static(int(on_tc), cm)
            if got == -1:  # a build this library does not have
                continue
            if got != tc.engine_static_bytes(cm, on_tc):
                fail(f"{name}: {got} bytes of static shared memory (tensor cores {on_tc}, {cm} edges a chunk; -2: "
                     f"its kernels differ), the host mirror says {tc.engine_static_bytes(cm, on_tc)}")
            builds += 1
            n += 1
        if not builds:
            fail(f"{name}: no build reports its static shared memory")
        fn = build.load(name).cbt_smem_bytes
        fn.argtypes, fn.restype = [ctypes.c_int] * 14, ctypes.c_longlong
        for a, b, sh, ns in cases:
            shd = tc.sh_dim(sh)
            for on_tc, cm, rt in ((True, tc.TM, 8), (False, tc.TM, 4), (False, tc.TM_WIDE, 1)):
                lay = tc.tp_layout(a, b, sh, tc.TNC if on_tc else tc.TN)
                d = tc.Dims(ns, ns, 3 * ns, 3 * ns, lay.din, lay.dout)
                want = tc.engine_smem_bytes(shd, cm, d, lay.n_x, rt, on_tc, len(lay.cg), len(lay.epi), lay.n_tiles)
                got = fn(int(on_tc), cm, shd, *d, lay.n_x, lay.n_tiles, len(lay.epi), len(lay.cg), rt)
                if got != want:
                    fail(f"{name}: {got} bytes of shared memory at {a} -> {b} ({sh}, tensor cores {on_tc}, {cm} "
                         f"edges a chunk), the host mirror says {want}")
                n += 1
    fn = build.load("tpconv_bwd").cbt_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    for a, b, sh, ns in cases:
        lay = tc.tp_layout(a, b, sh)
        for bt, _ in tpconv_bwd.BUILDS:
            args = (bt, 3 * ns, 3 * ns, lay.din, tc.sh_dim(sh), lay.dout, lay.n_x)
            if fn(*args) != tpconv_bwd.bwd_smem_bytes(*args):
                fail(f"tpconv_bwd: {fn(*args)} bytes of shared memory at {a} -> {b}, the host mirror says "
                     f"{tpconv_bwd.bwd_smem_bytes(*args)}")
            n += 1
    return n


def wide_phase(dev) -> None:
    """Phase 9: the ns=48/nv=10 ladder (see the module docstring)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position, sample
    from confidence_bootstrapping_tpu_torch.train import train_loop

    n = layout_check()
    print(f"layout mirror: {n} shared-memory sizes of every kernel library equal the host's", flush=True)
    cfg = ScoreModelConfig(ns=WIDE_NS, nv=WIDE_NV, lm_embedding_dim=LM_DIM)
    print(f"wide ladder: ns={cfg.ns} nv={cfg.nv} (H={3 * cfg.ns}), layers "
          f"{ladder_pairs(cfg.ns, cfg.nv, cfg.reduce_pseudoscalars)}", flush=True)

    # one training step's kernels at H=144, replayed (dropout on: the mask variants too)
    tcfg = TrainConfig()
    padded = host_complex(LM_DIM)[0]
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    state = train_loop.init_train_state(model, tcfg)
    batch = replicate_complex(padded, 2, device=dev)
    step = train_loop.make_train_step(cfg, tcfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    step(state, batch, gen)  # warm-up
    calls = record_train_calls(lambda: step(state, batch, gen))
    torch.cuda.synchronize()
    replay_train_kernels(calls)
    del model, state, calls
    torch.cuda.empty_cache()

    # card against CPU: a 3-step probability-flow sample at B=8 with two compaction boundaries
    scfg = SamplerConfig(inference_steps=STEPS_WIDE_CHECK, ode=True, rec_phase_steps=(1, 2), rec_phase_caps=(256, 128))
    pos = padded["lig_pos"][None] + np.random.RandomState(4).randn(B_WIDE_CHECK, *padded["lig_pos"].shape).astype(
        np.float32) * 2
    res = []
    for device in (dev, torch.device("cpu")):
        model = TensorProductScoreModel(cfg, device=device, seed=0)
        b8 = replicate_complex(padded, B_WIDE_CHECK, device=device).replace(lig_pos=torch.as_tensor(pos, device=device))
        t0 = time.perf_counter()
        res.append(sample(model, b8, cfg, scfg, device=device)[0].lig_pos.cpu())
        print(f"wide {STEPS_WIDE_CHECK}-step B={B_WIDE_CHECK} sample on {device.type}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    err = (res[0] - res[1]).abs().max().item()
    moved = (res[0] - torch.as_tensor(pos)).abs().max().item()
    print(f"wide sample card vs CPU: max_abs_err {err:.3g} A (tolerance {SAMPLE_ATOL} A), poses moved {moved:.3g} A",
          flush=True)
    if not (err <= SAMPLE_ATOL and moved > 0.1):
        fail("the wide-ladder sample on the card disagrees with the CPU")

    # the timed B=32 20-step sample, phase 5's path at this width
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    batch = replicate_complex(padded, B_POSES, device=dev)
    N = batch.rec_pos.shape[1]
    plan = [(s, c) for s, c in PLAN if c < N]
    scfg = SamplerConfig(inference_steps=STEPS, rec_phase_steps=tuple(s for s, _ in plan),
                         rec_phase_caps=tuple(c for _, c in plan))
    b0 = randomize_position(batch, torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    run = lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    print(f"wide sample warm-up: {time.perf_counter() - t0:.3f} s", flush=True)
    # every call of this sample (the same noise as the timed run) through kernel and plain version
    replay_sample(model, run, "wide sample")
    t0 = time.perf_counter()
    (final, _), launches = counted(run)
    secs = time.perf_counter() - t0
    want = expected_launches(model, STEPS)
    print(f"wide sample (ns={cfg.ns}, nv={cfg.nv}): B={B_POSES}, {STEPS} steps, plan {plan}: {secs:.4f} s, "
          f"{B_POSES / secs:.3f} poses/s; launches {launches}; expected from the config {want}", flush=True)
    if launches != want:
        fail("the wide-ladder sample did not run every TP-conv through its kernel")
    if not torch.isfinite(final.lig_pos).all():
        fail("the wide-ladder sample's poses are not finite")
    profile_run(run, secs * 1e3)


def tc_spills(logs: dict) -> dict:
    """{kernel: bytes of spill stores} from the ptxas logs, for the kernels
    that run the tensor-core stage (their weights argument is TPWeightsTC)."""
    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            if "Function properties for " in line:
                name = line.split("Function properties for ")[-1].strip()
            elif name and "TPWeightsTC" in name and "bytes spill stores" in line:
                out[name.split("PK")[0].lstrip("_Z0123456789")] = int(line.split("bytes spill stores")[0].split(",")[-1])
    return out


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
    hgmma = build.hgmma_counts()
    print(f"HGMMA instructions (cuobjdump -sass) per library: {hgmma}", flush=True)
    if any(hgmma[name] == 0 for name in TC_KERNELS):
        fail(f"{', '.join(TC_KERNELS)} must run the H -> W product on the tensor cores")
    spills = tc_spills(logs)
    print(f"tensor-core kernels' spill stores (ptxas): {spills}", flush=True)
    if len(spills) != len(TC_KERNELS) or any(spills.values()):
        fail("every tensor-core kernel must build, with no spill")
    model, b0, run = main_path(dev)
    rows = kernel_phase(model, run)
    torch.cuda.synchronize()
    model_phase(dev)
    torch.cuda.synchronize()
    launches, final_pos = sample_phase(model, b0, run)
    torch.cuda.synchronize()
    conf_rows, conf_launches, rerank = confidence_phase(dev, final_pos)
    torch.cuda.synchronize()
    train_rows, train_launches = train_phase(dev)
    torch.cuda.synchronize()
    eval_launches, calls = eval_phase(dev, rerank)
    torch.cuda.synchronize()
    pairs_launches, calls_8b = composed_pairs_phase(dev)
    calls.update(calls_8b)
    eval_rows = replay(calls, eval_kernels())
    for r in eval_rows[1:]:  # rows 5 and 6 launch the edge-list kernel's inference instance
        r["source"] = "confidence_bootstrapping_tpu_torch/csrc/tpconv_edge.cu"
    replay_v1(calls)
    torch.cuda.synchronize()
    wide_phase(dev)
    torch.cuda.synchronize()

    launches.update(conf_launches)
    launches.update(train_launches)
    launches.update(tpconv_cross=eval_launches["tpconv_cross"], tpconv_msgs=eval_launches["tpconv_msgs"],
                    tpconv_nbr=pairs_launches["tpconv_nbr"])
    rows += conf_rows + train_rows + eval_rows
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
