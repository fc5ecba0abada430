"""Where the tensor-core rec kernel's time goes, stage by stage, on the card.

Builds copies of ``csrc/tpconv_rec.cu`` whose engine (``csrc/tpconv_engine.cuh``)
has stages of the tensor-core path cut out, and times each on the score
model's full-width 100 -> 100 layer (B=32, N=512, K=24, 70% of the neighbour
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
they do not overlap. Prints the card's name and power limit first. Run from
the repository root on a machine with the CUDA toolkit:

    python scripts/engine_ablation.py

Build outputs go to ``build/engine_ablation/``.
"""

import ctypes
import os
import shutil
import subprocess
import sys

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
    no_contrib = cut(no_tiles, "  contributions_tc(sm, L, T);\n")
    return {
        "full": src,
        "no_mma": cut(cut(src, "mma_tile(acc, hi, lo, ring + (tiles & 1) * stage_sz, L.hp);"),
                      "mma_tile(acc, hi, lo, ring + ((cur + 1) & 1) * stage_sz, L.hp);"),
        "no_epilogue": src[:loop] + cut(src[loop:], epi),
        "no_tiles": no_tiles,
        "no_contributions": no_contrib,
        "no_hidden": cut(no_contrib, "  hidden_layer_tc(sm, L, d, W);\n"),
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("engine_ablation: no CUDA device")
    sys.path.insert(0, ROOT)
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


if __name__ == "__main__":
    main()
