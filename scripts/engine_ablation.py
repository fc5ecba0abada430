"""Where the tensor-core rec kernel's time goes, stage by stage, on the card.

Builds copies of ``csrc/tpconv_rec.cu`` whose engine (``csrc/tpconv_engine.cuh``)
has stages of the tensor-core path cut out, and times each on the score
model's 100 -> 100 layer (the trunk with its pseudoscalars unreduced, wider
than the sample's 74 -> 74; B=32, N=512, K=24, 70% of the neighbour
slots valid, weights and data from seed 0):

  full              the kernel as built;
  no_mma            the wgmma products not issued (tiles still streamed);
  no_epilogue       the per-tile CG epilogue left out;
  no_tiles          the whole H -> W tile loop left out;
  no_contributions  and the CG contributions X;
  no_hidden         and the hidden layer (what is left: compaction, fill, the
                    receiver sums and the output).

A cut kernel computes something else; only the full one is compared with
the plain version. The differences between rows are the stages' costs where
they do not overlap.

Then pb's receivers a block (RT): every pb call of one of chip_smoke.py's
phase-5 samples (B=32 poses, 20 steps, 160 calls), recorded, then replayed
at each RT of a list, marking the one ``tpconv_lig.pb_rows_per_block``
picks: the mean ms per call (CUDA events), the blocks and waves of the grid,
and each RT's first calls against the plain version; then the same calls cut
to their first 8 poses (B=8) and with their poses twice (B=64).

Then row 4's receivers a block on its tensor-core build: every
``fused_tpconv_cross`` call of one of chip_smoke.py's phase-8 evaluator samples
(cross cap pinned at 100, the derived plan, B=32, 20 steps, 100 calls),
replayed at each RT of a list (the wrapper's rule ``cross_rows_per_block``
gives RT=1 at K=100; pb's one-wave rule RT=6 at B=32), at B=32 and cut or
doubled to B=8 and B=64, as for pb.

Then cross_g's receivers a block on its tensor-core build: every
``fused_tpconv_cross_g`` call of one of chip_smoke.py's phase-6 confidence
forwards (B=32 poses near the crystal pose, 10 calls), by list (ligand <-
receptor at K=64, ligand <- atom at K=32), replayed at each RT of the same
list as row 4's (the rule gives RT=1 and 2). ``--cross-g-rows`` runs this
part alone.

Then the edge-list kernel's rows a block (RT) on its tensor-core build:
every row-6 call (``fused_tpconv_msgs``, K=100) of one phase-8 evaluator
sample and every edge-list call of one B=16 phase-7 training step (ligand
pairs and bonds, ligand <-> receptor, the center and torsion convolutions,
with the dropout mask), replayed at each RT of a list: mean ms per call by
list (K, sums or per-edge messages) and RT, each RT's first calls against
the plain version; the wrapper's rule ``cross_rows_per_block``
marked. ``--edge-rows`` runs this part alone.

Then where the edge backward's tensor-core build spends its time: copies of
``csrc/tpconv_bwd.cu`` whose per-edge kernel has one stage cut out each
(d_w to scratch, the d_X epilogue, the sender and harmonic gradients, the
recompute's wgmma products, the whole tile loop, and the CG contributions
with it), each run on a full-width receptor group of a B=16 training step
(the 74 -> 74 trunk layer, T = 16 x 512 x 24 = 196,608 slots, 19% masked,
dropout 0.1, seed 0) under torch.profiler: the device time of each of the
build's kernels (the per-edge kernel, the dh product, the MLP backward, the
two weight-gradient products).

Prints the card's name and power limit first. Run from the repository root
on a machine with the CUDA toolkit:

    python scripts/engine_ablation.py

Build outputs go to ``build/engine_ablation/``.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "confidence_bootstrapping_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "engine_ablation")


def variants(src: str) -> dict:
    """{name: engine source} of the cuts above, each an edit of ``src``."""

    def cut(s, old, new=""):
        if old not in s:
            raise RuntimeError(f"the engine no longer has the stage this script cuts: {old[:60]!r}")
        return s.replace(old, new)

    loop = src.index("__device__ void weighted_tp_tc(")
    epi = src[src.index("    const int e0 = ", loop):src.index("    __syncthreads();\n  }\n  tiles += nt;", loop)]
    no_tiles = cut(cut(src, "const int nt = T.n_tiles, stage_sz", "const int nt = 0, stage_sz"),
                   "  float acc[12];\n  mbar_wait(", "  float acc[12];\n  if (nt == 0) return;\n  mbar_wait(")
    no_contrib = cut(no_tiles, "  contributions_tc<SHD>(sm, L, T);\n")
    return {
        "full": src,
        "no_mma": cut(cut(src, "mma_tile(acc, hi, lo, ring + (tiles & 1) * stage_sz, L.hp);"),
                      "mma_tile(acc, hi, lo, ring + ((cur + 1) & 1) * stage_sz, L.hp);"),
        "no_epilogue": src[:loop] + cut(src[loop:], epi),
        "no_tiles": no_tiles,
        "no_contributions": no_contrib,
        "no_hidden": cut(no_contrib, "    hidden_layer_tc(sm, L, d, W);\n", "    ;\n"),
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("engine_ablation: no CUDA device")
    sys.path.insert(0, ROOT)
    alone = {"--edge-rows": edge_rows, "--cross-g-rows": cross_g_rows}
    for flag, part in alone.items():
        if flag in sys.argv[1:]:
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip(), flush=True)
            part(torch.device("cuda"))
            return
    from confidence_bootstrapping_tpu_torch.ops.cuda import build, tpconv_rec
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import pack_weights
    from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with open(os.path.join(CSRC, "tpconv_engine.cuh")) as f:
        cuts = variants(f.read())
    procs = {}
    for name, src in cuts.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "tpconv_engine.cuh"), "w") as f:
            f.write(src)
        shutil.copy(os.path.join(CSRC, "tpconv_rec.cu"), d)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
                                        os.path.join(d, "tpconv_rec.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    ir, ns, (B, N, K) = "32x0e + 6x1o + 6x1e + 32x0o", 32, (32, 512, 24)
    W = WeightedTensorProduct(ir, "1x0e + 1x1o", ir).weight_numel
    args = [torch.randn(B, N, 100, generator=g), torch.randn(B, N, 3, generator=g) * 8,
            torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
            torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3]
    args += [torch.randn(s, generator=g) * 0.2 for s in ((96, 96), (96,), (96, W), (W,))]
    args = [t.to(dev) for t in args]
    packed = pack_weights(*args[6:], ir, ir)
    print(f"rec at {ir} -> {ir}, B={B} N={N} K={K}, {int(args[5].sum())} valid edges", flush=True)

    load = build.load
    times = {name: [] for name in cuts}
    try:
        for _ in range(2):
            for name in cuts:
                lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
                lib.cbt_error_string.argtypes = [ctypes.c_int]
                lib.cbt_error_string.restype = ctypes.c_char_p
                build.load = lambda _name, lib=lib: lib
                run = lambda: tpconv_rec.fused_tpconv_rec(*args, ir, ir, ns, packed=packed)
                got = run()
                if name == "full":
                    want = tpconv_rec.tpconv_rec_plain(*args, ir, ir, ns)
                    err, scale = float((got - want).abs().max()), float(want.abs().max())
                    if err > 2e-4 * max(1.0, scale):
                        sys.exit(f"the full kernel disagrees with its plain version: {err:.3g}")
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    run()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 5)
    finally:
        build.load = load
    for name, ts in times.items():
        print(f"{name:17s} {', '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
    ms = {name: min(ts) for name, ts in times.items()}
    for stage, (a, b) in {"wgmma products (not hidden by the epilogue)": ("full", "no_mma"),
                          "epilogue (not hidden by the products)": ("full", "no_epilogue"),
                          "H -> W tile loop": ("full", "no_tiles"),
                          "CG contributions": ("no_tiles", "no_contributions"),
                          "hidden layer": ("no_contributions", "no_hidden")}.items():
        print(f"{stage}: {ms[a] - ms[b]:.4f} ms", flush=True)
    print(f"compaction, fill, receiver sums and output: {ms['no_hidden']:.4f} ms", flush=True)
    pb_rows(dev)
    cross_rows(dev)
    cross_g_rows(dev)
    edge_rows(dev)
    bwd_stages(dev)


CROSS_RT = (1, 2, 3, 4, 6, 8, 12)


def bwd_variants(src: str) -> dict:
    """{name: backward source} with one stage of the tensor-core per-edge kernel cut out each."""
    k = src.index("__global__ void __launch_bounds__(NTB) tpconv_bwd_edge_tc_kernel")
    head, body = src[:k], src[k:]

    def cut(s, old, new):
        if old not in s:
            raise RuntimeError(f"the backward no longer has the stage this script cuts: {old[:60]!r}")
        return s.replace(old, new)

    none = "for (int i = tid; i < 0; i += NTB) {"
    no_tiles = cut(cut(body, "const int nt = a.n_tiles, stage_sz", "const int nt = 0, stage_sz"),
                   "  float acc[12];\n  mbar_wait(bar, 0);\n  mma_tile(acc, hi, lo, ring, L.hp);", "  float acc[12];")
    cuts = {
        "full": body,
        "no_dw": cut(body, "for (int i = tid; i < nrow * TNC; i += NTB) {", none),
        "no_dX": cut(body, "for (int i = tid; i < here * CMT; i += NTB) {", none),
        "no_dx_dsh": cut(body, "for (int i = tid; i < nrow * (a.Din + a.Dsh); i += NTB) {", none),
        "no_mma": cut(cut(body, "mma_tile(acc, hi, lo, ring, L.hp);", ""),
                      "mma_tile(acc, hi, lo, ring + ((t + 1) & 1) * stage_sz, L.hp);", ""),
        "no_tiles": no_tiles,
        "no_contributions": cut(no_tiles, "for (int i = tid; i < CMT * a.S; i += NTB) {", none),
    }
    return {name: head + b for name, b in cuts.items()}


def bwd_stages(dev) -> None:
    """The edge backward's kernels by stage (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from confidence_bootstrapping_tpu_torch.ops.cuda import build, tpconv_bwd
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import SH_IRREPS, sh1
    from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

    with open(os.path.join(CSRC, "tpconv_bwd.cu")) as f:
        cuts = bwd_variants(f.read())
    procs = {}
    for name, src in cuts.items():
        d = os.path.join(OUT, "bwd_" + name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "tpconv_bwd.cu"), "w") as f:
            f.write(src)
        shutil.copy(os.path.join(CSRC, "tpconv_engine.cuh"), d)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
                                        os.path.join(d, "tpconv_bwd.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"nvcc failed for the backward's {name}:\n{log}")
    ir, T, F, H = "32x0e + 6x1o + 6x1e + 6x0o", 16 * 512 * 24, 96, 96
    W = WeightedTensorProduct(ir, SH_IRREPS, ir).weight_numel
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev)
    attr, x, sh = mk(T, F), mk(T, 74), sh1(mk(T, 3))
    valid = (torch.rand(T, generator=g) >= 0.19).to(dev)
    cot = (mk(T, 74) * valid[:, None]).contiguous()
    dm = ((torch.rand(T, H, generator=g) > 0.1).float() / 0.9).to(dev)
    ins = (attr, x, sh, cot, dm, *[mk(*s) * 0.2 for s in ((F, H), (H,), (H, W), (W,))], ir, SH_IRREPS, ir)
    print(f"edge backward at {ir} -> {ir}: T={T}, {int(valid.sum())} valid edges, dropout 0.1; device ms a call "
          f"(torch.profiler, 3 calls, second pass):", flush=True)
    load = build.load
    names = {"tpconv_bwd_edge_tc": "per-edge", "tn_gemm_tc_kernel<96, false": "dh product", "mlp_bwd": "MLP backward",
             "tn_gemm_tc_kernel<96, true": "weight products", "sum_splits": "slice sums"}
    try:
        for rep in range(2):
            for name in cuts:
                lib = ctypes.CDLL(os.path.join(OUT, "bwd_" + name, "lib.so"))
                lib.cbt_error_string.argtypes = [ctypes.c_int]
                lib.cbt_error_string.restype = ctypes.c_char_p
                build.load = lambda _name, lib=lib: lib
                tpconv_bwd.edge_bwd(*ins, valid=valid)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        tpconv_bwd.edge_bwd(*ins, valid=valid)
                    torch.cuda.synchronize()
                t = {v: 0.0 for v in names.values()}
                for e in prof.key_averages():
                    for key, v in names.items():
                        if key in e.key:
                            t[v] += e.self_device_time_total / 3e3
                if rep:
                    print(f"  {name:17s} " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    finally:
        build.load = load


def cross_rows(dev) -> None:
    """Row 4's time per call by receivers a block, on the calls of one
    evaluator sample (B=32), cut to 8 poses and doubled to 64."""
    import dataclasses

    import torch

    import chip_smoke
    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position, sample, with_derived_plan

    cfg = dataclasses.replace(ScoreModelConfig(lm_embedding_dim=chip_smoke.LM_DIM), cross_cap=chip_smoke.EVAL_CAP,
                              cross_cap_frac=0.0)
    padded = chip_smoke.host_complex(chip_smoke.LM_DIM)[0]
    scfg = with_derived_plan(cfg, SamplerConfig(inference_steps=chip_smoke.STEPS), padded["rec_pos"],
                             padded["rec_mask"])
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    b0 = randomize_position(replicate_complex(padded, chip_smoke.B_POSES, device=dev),
                            torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    run = lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    calls = chip_smoke.record_calls(run, ("tpconv_cross",))["tpconv_cross"]
    n_pose = 7  # the per-pose arguments: receivers, positions, sender table and positions, idx, embedding, mask
    for B, batch in ((32, lambda t: t), (8, lambda t: t[:8].contiguous()), (64, lambda t: torch.cat([t, t]))):
        cross_rows_at([(tuple(batch(a) if i < n_pose else a for i, a in enumerate(args)), kw) for args, kw in calls],
                      dev)


def cross_g_rows(dev) -> None:
    """cross_g's time per call by receivers a block, on the calls of one
    B=32 confidence forward of chip_smoke.py's phase 6, list by list."""
    import torch

    import chip_smoke
    from confidence_bootstrapping_tpu_torch.config import confidence_model_config
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

    cfg = confidence_model_config(lm_embedding_dim=chip_smoke.LM_DIM)
    padded, hc, _ = chip_smoke.host_complex(chip_smoke.LM_DIM, all_atoms=True)
    padded["lig_pos"][: len(hc.orig_lig_pos)] = hc.orig_lig_pos  # the crystal pose
    model = AllAtomScoreModel(cfg, device=dev, seed=0)
    batch = replicate_complex(padded, chip_smoke.B_POSES, device=dev)
    poses = chip_smoke.near_crystal_poses(padded, chip_smoke.B_POSES).to(dev)
    calls = chip_smoke.record_calls(lambda: score_confidence(model, batch, lig_pos=poses),
                                    ("tpconv_cross_g",))["tpconv_cross_g"]
    for K in sorted({a[4].shape[2] for a, _ in calls}):
        cross_rows_at([c for c in calls if c[0][4].shape[2] == K], dev, "cross_g", tpconv_g.fused_tpconv_cross_g,
                      tpconv_g.tpconv_cross_g_plain, "confidence forward")


def cross_rows_at(calls, dev, what: str = "row 4", fn=None, plain=None, source: str = "evaluator sample") -> None:
    """Replay a cross kernel's calls (row 4's by default) at each RT of
    CROSS_RT: the first three against the plain version, then all of them
    timed (CUDA events), twice."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g, tpconv_lig, tpconv_rec

    fn, plain = fn or tpconv_rec.fused_tpconv_cross, plain or tpconv_rec.tpconv_cross_plain
    B, L = calls[0][0][0].shape[:2]
    K = calls[0][0][4].shape[2]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = sum(int(a[6].sum()) for a, _ in calls) / len(calls)
    print(f"{what}: {len(calls)} calls of one {source}, B={B} L={L} K={K}, {edges:.0f} valid edges a call; "
          f"the wrapper's rule RT={tpconv_g.cross_rows_per_block(K)}, one wave RT="
          f"{tpconv_lig.pb_rows_per_block(B, L, n_sm)}", flush=True)
    rule = tpconv_g.cross_rows_per_block  # launch_cross's receivers a block
    times = {rt: [] for rt in CROSS_RT}
    try:
        for _ in range(2):
            for rt in CROSS_RT:
                tpconv_g.cross_rows_per_block = lambda K, chunk=64, rt=rt: rt
                for args, kw in calls[:3]:
                    got, want = fn(*args, **kw), plain(*args)
                    err, scale = float((got - want).abs().max()), float(want.abs().max())
                    if err > 2e-4 * max(1.0, scale):
                        sys.exit(f"{what} at B={B}, RT={rt} disagrees with its plain version: {err:.3g}")
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for args, kw in calls:
                    fn(*args, **kw)
                end.record()
                torch.cuda.synchronize()
                times[rt].append(start.elapsed_time(end) / len(calls))
    finally:
        tpconv_g.cross_rows_per_block = rule
    for rt, ts in times.items():
        blocks = B * -(-L // rt)
        print(f"{what} B={B} K={K} RT={rt:2d}: {blocks:4d} blocks, {-(-blocks // n_sm)} wave(s): "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms a call", flush=True)


PB_RT = (2, 3, 4, 6, 8, 12, 24)
EDGE_RT = (1, 2, 3, 4, 6, 8, 12, 16)


def edge_rows(dev) -> None:
    """The edge-list kernel's time per call by rows a block (see the module
    docstring): row 6's calls of one evaluator sample, then the edge-list
    calls of one training step."""
    import dataclasses

    import torch

    import chip_smoke
    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge, tpconv_v3
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position, sample, with_derived_plan
    from confidence_bootstrapping_tpu_torch.train import train_loop

    cfg = dataclasses.replace(ScoreModelConfig(lm_embedding_dim=chip_smoke.LM_DIM), cross_cap=chip_smoke.EVAL_CAP,
                              cross_cap_frac=0.0)
    padded = chip_smoke.host_complex(chip_smoke.LM_DIM)[0]
    scfg = with_derived_plan(cfg, SamplerConfig(inference_steps=chip_smoke.STEPS), padded["rec_pos"],
                             padded["rec_mask"])
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    b0 = randomize_position(replicate_complex(padded, chip_smoke.B_POSES, device=dev),
                            torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    run = lambda: sample(model, b0, cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    calls = chip_smoke.record_calls(run, ("tpconv_msgs",))["tpconv_msgs"]
    edge_rows_at("row 6 (evaluator sample)", [(a, kw, False) for a, kw in calls], tpconv_v3.fused_tpconv_msgs,
                 lambda a, kw: tpconv_v3.tpconv_msgs_plain(*a))
    del calls, model, b0
    torch.cuda.empty_cache()

    tcfg = TrainConfig()
    model = TensorProductScoreModel(ScoreModelConfig(lm_embedding_dim=chip_smoke.LM_DIM), device=dev, seed=0)
    state = train_loop.init_train_state(model, tcfg)
    batch = replicate_complex(padded, tcfg.batch_size, device=dev)
    step = train_loop.make_train_step(model.cfg, tcfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    step(state, batch, gen)
    calls = chip_smoke.record_train_calls(lambda: step(state, batch, gen))["tpconv_edge"]
    kernel = lambda *a, **kw: tpconv_edge.fused_tpconv_edge(*a[:11], dmask=a[11], sum_k=a[12])
    edge_rows_at("edge lists (training step)", [(a, {}, a[12]) for a, _ in calls], kernel,
                 lambda a, kw: tpconv_edge.tpconv_edge_plain(*a))


def edge_rows_at(what: str, calls, kernel, plain) -> None:
    """Replay edge-list calls (args, kwargs, sum_k) at each RT of EDGE_RT,
    grouped by list (K, sums or per edge): the first call of each group
    against the plain version, then every call timed (CUDA events), twice."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge

    groups = {}
    for args, kw, sum_k in calls:
        M, K = args[0].shape[:2]
        groups.setdefault((K, "sums" if sum_k else "per edge"), []).append((args, kw))
    rule = tpconv_edge.cross_rows_per_block
    try:
        for (K, kind), group in groups.items():
            edges = sum(int(a[3].sum()) for a, _ in group) / len(group)
            rows = sum(a[0].shape[0] for a, _ in group) / len(group)
            print(f"{what}: {len(group)} calls at K={K} ({kind}), {rows:.0f} rows and {edges:.0f} valid edges a call; "
                  f"the wrapper's rule RT={rule(K)}", flush=True)
            times = {rt: [] for rt in EDGE_RT}
            for _ in range(2):
                for rt in EDGE_RT:
                    tpconv_edge.cross_rows_per_block = lambda K, chunk=64, rt=rt: rt
                    args, kw = group[0]
                    with torch.no_grad():
                        got, want = kernel(*args, **kw), plain(args, kw)
                    err, scale = float((got - want).abs().max()), float(want.abs().max())
                    if err > 2e-4 * max(1.0, scale):
                        sys.exit(f"{what} at K={K}, RT={rt} disagrees with its plain version: {err:.3g}")
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for args, kw in group:
                        kernel(*args, **kw)
                    end.record()
                    torch.cuda.synchronize()
                    times[rt].append(start.elapsed_time(end) / len(group))
            for rt, ts in times.items():
                print(f"  K={K} {kind} RT={rt:2d}: {', '.join(f'{t:.4f}' for t in ts)} ms a call"
                      f"{'  (rule)' if rt == rule(K) else ''}", flush=True)
    finally:
        tpconv_edge.cross_rows_per_block = rule


def crystal_pb_edges() -> None:
    """pb's edges at the 1a0q crystal pose (no card needed): the dense pairs
    within the score model's ligand radius and the bonds, and the valid
    edges of each block at each RT (the chunk fill the RT choice trades)."""
    import chip_smoke
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig

    padded = chip_smoke.host_complex(0)[0]
    pos, m = padded["lig_pos"], padded["lig_mask"]
    L = len(pos)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    pairs = (d < ScoreModelConfig().lig_max_radius) & m[:, None] & m[None] & ~np.eye(L, dtype=bool)
    src, bonds = padded["lig_edge_src"], padded["lig_edge_mask"]
    print(f"pb at the crystal pose: {int(pairs.sum())} pairs within {ScoreModelConfig().lig_max_radius} A and "
          f"{int(bonds.sum())} bonds over {int(m.sum())} atoms", flush=True)
    for rt in PB_RT:
        per = [int(pairs[i:i + rt].sum() + ((src >= i) & (src < i + rt) & bonds).sum()) for i in range(0, L, rt)]
        print(f"  RT={rt:2d}: valid edges a block {per}", flush=True)


def pb_rows(dev) -> None:
    """pb's time per call by receivers a block, on the calls of one sample
    (B=32), and on the same calls cut to their first 8 poses and with their
    poses twice (B=64)."""
    import torch

    import chip_smoke

    crystal_pb_edges()
    _, _, run = chip_smoke.main_path(dev)
    calls = chip_smoke.record_calls(run, ("tpconv_pb",))["tpconv_pb"]
    n_pose = 8  # the per-pose arguments: features, positions, pair embedding and mask, bonds
    for B, batch in ((32, lambda t: t), (8, lambda t: t[:8].contiguous()), (64, lambda t: torch.cat([t, t]))):
        pb_rows_at([(tuple(batch(a) if i < n_pose else a for i, a in enumerate(args)), kw) for args, kw in calls],
                   dev)


def pb_rows_at(calls, dev) -> None:
    """Replay pb's calls at each RT of PB_RT: the first three against the
    plain version, then all of them timed (CUDA events), twice."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_lig

    B, L = calls[0][0][0].shape[:2]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    picked = tpconv_lig.pb_rows_per_block(B, L, n_sm)
    edges = sum(int(a[3].sum()) + int(a[7].sum()) for a, _ in calls) / len(calls)
    print(f"pb: {len(calls)} calls of one sample, B={B} L={L}, {edges:.0f} valid edges a call; {n_sm} SMs; "
          f"pb_rows_per_block picks RT={picked}", flush=True)
    rule = tpconv_lig.pb_rows_per_block
    times = {rt: [] for rt in PB_RT}
    try:
        for _ in range(2):
            for rt in PB_RT:
                tpconv_lig.pb_rows_per_block = lambda B, L, n, rt=rt: rt
                for args, kw in calls[:3]:
                    got, want = tpconv_lig.fused_tpconv_pb(*args, **kw), tpconv_lig.tpconv_pb_plain(*args)
                    err, scale = float((got - want).abs().max()), float(want.abs().max())
                    if err > 2e-4 * max(1.0, scale):
                        sys.exit(f"pb at B={B}, RT={rt} disagrees with its plain version: {err:.3g}")
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for args, kw in calls:
                    tpconv_lig.fused_tpconv_pb(*args, **kw)
                end.record()
                torch.cuda.synchronize()
                times[rt].append(start.elapsed_time(end) / len(calls))
    finally:
        tpconv_lig.pb_rows_per_block = rule
    for rt, ts in times.items():
        blocks = B * -(-L // rt)
        print(f"pb B={B} RT={rt:2d}: {blocks:4d} blocks, {-(-blocks // n_sm)} wave(s): "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms a call{'  (picked)' if rt == picked else ''}", flush=True)


if __name__ == "__main__":
    main()
