"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each one fails the script when it fails):
  1. the card's name and power limit (nvidia-smi);
  2. build every TP-conv kernel from csrc/ with nvcc for sm_90a (timed), with
     each kernel's ptxas line and each library's count of HGMMA (wgmma)
     instructions from cuobjdump -sass: rec (with and without the dropout
     mask), pb, cross_rev, rec_g, cross_g, row 4 (tpconv_cross) and the
     edge-list kernel (tpconv_edge), whose H -> W product runs on the tensor
     cores, and
     the edge backward (tpconv_bwd), whose three H x W products do, must have
     some, and their tensor-core kernels no spill;
  3. per kernel, on every call of one sample of phase 5's path (recorded,
     then replayed): the kernel against its plain PyTorch version on the same
     inputs (stated tolerance), both timed, and its two bounds (``bounds``:
     the tensor-core bound and the float32 one); by shape and as means over
     the sample's launches; rec's and pb's output bit for bit across two
     launches;
  4. the full-width score model on 1a0q at B=2: CUDA with the kernels against
     the same model and weights on the CPU with the plain versions; a 3-step
     sample card against CPU within 1e-2 A or twice the card's own spread
     over reruns (``rerun_tolerance``), whichever is larger;
  5. bench.py's path on the port: 1a0q, random ESM-sized receptor features,
     B=32 poses, seeded random weights, 20 steps, shared receptor embedding,
     phase plan 6:256,12:128; one warm-up and one timed run, poses/s, and the
     launch count of every kernel against the count the config implies;
     one more sample under torch.profiler for device time by kernel; the
     sample's own spread over PHASE5_RERUNS reruns (``sample_tolerance``),
     the tolerance of phases 10, 15 and 18 on its poses;
  6. the confidence rerank on the port: the full-width pretrained confidence
     architecture (all-atom, lmax=2) with seeded random weights on 1a0q with
     seeded receptor atoms (3183 over the 416 residues); phase 5's 32 final
     poses scored and ranked as the dock CLI ranks them; then 32 poses near
     the crystal pose scored with one warm-up and one timed forward (poses/s,
     the crop's kept residues and atoms, launches of rec_g and cross_g against
     the config), the card against the CPU on 2 of them, every rec_g and
     cross_g call of the timed forward replayed through kernel and plain
     version as in phase 3 (both bit for bit across two launches; every
     cross_g call on its tensor-core build), and one forward under
     torch.profiler;
  7. training: one step of the full-width score model at B=2 and dropout 0,
     the card against the CPU (loss, every parameter's gradient, the batch
     statistics after it); then TrainConfig() steps at B=16 (1a0q replicated)
     with dropout 0.1: one warm-up and 5 timed steps (median ms, training
     poses/s, the split into noise + forward, backward and optimiser + EMA by
     CUDA events, the launches per step of the edge-list forward, rec with the
     dropout mask and the edge backward against the config), the eval loss in
     batch-statistics mode over 8 fixed draws before and after them, every
     call of one more step replayed through kernel and plain version (the
     edge-list forward and rec with the mask bit for bit across two launches;
     and the two autograd ops forward and backward; the edge backward by call
     kind, receptor group or edge list, bit for bit across two launches, exact
     zeros on the masked edges, its device time by stage and its
     weight-gradient reduction beside torch.matmul's time for the same
     products), one step under torch.profiler.
  8. the evaluator's path with a pinned cross cap (``cli/infer.py:355-571``
     for one complex): the full-width score model with cross_cap=100 and
     cross_cap_frac=0 (``infer --cross_cap 100``), so the cross lists' K=100
     is off the 16-grid at every receptor bucket and the trunk composes
     ligand <- receptor (row 4, ``tpconv_cross``) and receptor <- ligand
     (row 6, ``tpconv_msgs``, then a scatter) instead of cross_rev; the
     phase plan from ``derive_phase_plan``, the cross-cap telemetry, a warm
     and a timed B=32 20-step sample (poses/s, launches against the config),
     the rerank with phase 6's confidence model (every cross_g call on its
     tensor-core build), symmetry RMSDs against the crystal pose (card
     against CPU), centroid and self distances, the metrics dictionary, one
     sample under torch.profiler;
     8b. row 5 (``tpconv_nbr``): the ligand padded to its own 23 atoms, so
     the pairs leave pb, in a 3-step ODE sample at B=8 and a B=2 forward
     (card against CPU), then phase 8's B=32 20-step sample at this bucket on
     the card (warm, then timed: poses/s, launches against the config);
     then every row 4/5/6 call of one sample of each replayed through kernel
     and plain version (rows 4, 5 and 6 bit for bit across two launches), and row 13's v1 API (rows 5 and 6 behind the v1
     signatures, no kernel of its own) on a few of them, printed.
  9. the wide ladder: the score model at ns=48/nv=10 (H=144, above the
     tensor-core stage's 96; DiffDock's published width), otherwise phase 5's
     model with seeded random weights: the host mirror of the kernels'
     shared-memory layouts against every library's exported bytes; one
     B=2 training step's calls (the edge backward at H=144, the edge-list
     forward and rec with the dropout mask) replayed through kernel and
     plain version (untimed); a 3-step ODE sample at B=4, card against CPU; then the
     B=32 20-step 1a0q sample: one run recorded and every rec, pb and
     cross_rev call of it (each layer pair, each phase's N, with and
     without reverse weights; the float32 builds at 32 edges a chunk)
     replayed through kernel and plain version as in phase 3 (untimed),
     then one timed with its launch counts and one more under
     torch.profiler.
 10. serve from model directories: phase 5's score model and phase 6's
     confidence model saved as model directories (model_config.yml and a
     Flax msgpack bundle, ``train.checkpoints.save_model_dir``; bytes and
     ms printed), loaded back onto the card with
     ``cli.dock.load_or_init_model`` (every parameter and buffer bit for
     bit), a model_config.yml with ``sh_lmax: 3`` refused; then
     the dock path from the loaded models, timed once: phase 5's sample
     (poses, plan, noise), the rerank and the ranking, every kernel's
     launches against the config, every cross_g call on its tensor-core
     build, the poses within phase 5's ``sample_tolerance`` of its poses
     and the confidences within MODEL_RTOL of phase 6's.
 11. the Confidence Bootstrapping loop (``bootstrapping/finetune``) at full
     width: phase 5's score model and phase 6's confidence model on 1a0q in
     its all-atom bucket, the CB defaults (8 samples x 20 steps a round,
     batch 16, fixed_length 100, at most 5 complexes a receptor, lr 1e-3, EMA
     rollouts) cut to 2 epochs with a rollout round each, the cutoff the
     median confidence of a round drawn with the loop's seed: no failed
     round and the cutoff applied; launches per round, confidence call and
     fine-tune step, and over the loop, against the config; epoch 1's
     rollout model against a fresh model with the EMA and the buffers;
     epoch 1's rollout and the last fine-tune step replayed through kernel
     and plain version on the moved weights; round 0's confidences and
     RMSDs against the CPU; the workdir's msgpack files and a train-state
     bundle back bit for bit and one more step from it; the offline cache
     written and read back; per round and epoch its walls and rates, then
     one more epoch under torch.profiler. Every line carries the card's name
     and power limit.
 12. confidence training (``confidence/``) at the pretrained confidence
     architecture's full width (phase 6's model, dropout 0.1): a filtering
     cache of 1a0q in its all-atom bucket rolled out by phase 5's score
     model (4 samples x 20 steps, timed; back from its pickle bit for bit),
     with near-crystal poses added as positives (random weights roll out no
     pose within the cutoff); the CLI's batch (16, lr 3e-4, cutoff 2 A, the
     2-4 A band left out, balanced); one warm-up and 5 timed
     ``make_confidence_train_step`` calls (median ms, training poses/s, the
     split into crop + forward, backward and optimiser + EMA by CUDA events,
     every kernel's launches per step against the config); every kernel
     call of one more step replayed through kernel and plain version (rec_g
     with the dropout mask on its tensor-core build, and timed on its
     float32 build too; the edge-list forward and the edge backward at
     lmax=2, each backward call's build printed; both autograd ops against
     plain autograd), one step under torch.profiler; one B=2 step card
     against CPU (loss, every gradient, the batch statistics; the dropout
     masks drawn on the card and moved; an edge-MLP first-layer row off its
     tolerance excused only at a hidden unit at the ReLU on the card, as in
     phase 15, ``relu_excused``); the eval step leaving the batch
     statistics as they were; a short ``train_confidence`` (4 epochs x 8
     batches, validation on 2 fixed batches) whose validation loss must
     fall, its ROC-AUC printed, each epoch also read on the batches' own
     statistics. Every line carries the card's name and power limit.
 13. dock and infer from files through the CLIs at full width: 1a0q written
     from the cache as a PDB (416 residues, the 3183 seeded atoms), an SDF
     (with the hydrogens its features count) and a per-chain ESM ``.pt``;
     phase 5's and phase 6's models as model directories; ``cli.dock.main``
     with 32 poses x 20 steps and the rerank: the featurized complex against
     the cache (ligand features, edges, torsions, mask_rotate and rec_f
     exact; positions within the files' rounding; the kNN lists as sets),
     32 ranked SDFs back to the returned poses in confidence order, the
     launches of its sample and rerank against the config, every kernel call
     of them replayed through kernel and plain version, the poses against a
     direct ``sample`` of the same batch and generator (within 1e-2 A or
     twice that sample's own spread over reruns); the dock timed
     (featurization s, poses/s beside phase 5's, rerank ms) and once under
     torch.profiler (idle share); a B=8 ``--pocket_knowledge`` dock; a
     3-step B=4 SVGD sample card against CPU; ``cli.infer.main`` over 1a0q
     and a seeded complex in other buckets (8 poses each, both models):
     ``metrics.json`` with 2 complexes and no failure, the RMSDs those of
     ``eval/rmsd`` on the saved poses. Every line carries the card's name and
     power limit.
 14. train from files through the training CLIs at full width: 1a0q and the
     seeded complex as files, 64 seeded small molecules as SDFs, phase 5's and
     phase 6's architectures as model directories without ESM features (the
     CLIs featurize none). ``cli.train`` over the two complexes (the default
     ``ScoreModelConfig``, batch 16, 2 epochs, the benchmark each epoch at 8
     poses x 20 steps, conformer matching on and timed apart): every step's
     launches against the config, every checkpoint file back bit for bit,
     the train-state bundle and history; a second call with
     ``--restart_dir`` resumes at epoch 2 and one more step from the bundle
     matches the first call's state; one epoch under torch.profiler (idle
     share). ``cli.train --dataset torsional`` on the molecules (batch 16, 2
     epochs; launches per step as the ligand layers imply), a B=2 torsional
     step card against CPU, every row 7/10/11 call of a step and every row
     2/5 call of an eval step (row 5 at a ligand's own size) replayed
     through kernel and plain version, every edge-list call on a tensor-core
     build. ``cli.bootstrap_gen`` with both models (8 poses x 20 steps, the
     cutoff at the median confidence of the same draws; the pickle back),
     then ``cli.train --add_bootstrapping_dataset`` on it; ``cli.finetune``
     (one epoch, one round, fixed_length 32: no failed round, launches per
     round and step, the workdir back); ``cli.confidence_train`` at phase 6's
     width (a cache of 4 poses x 20 steps, one epoch of 4 batches at 16, the
     workdir loaded onto the card, the validation loss finite, then
     ``--test`` at 2 poses). Every line carries the card's name and power
     limit.
 15. reference checkpoints and the legacy models: phase 5's and phase 6's
     models written as the reference ships them (``reference_state_dict``:
     the e3nn state dict, a raw file, a ``{epoch, model, optimizer,
     ema_weights}`` bundle and DataParallel's ``module.`` prefix, with a
     ``model_parameters.yml`` in the reference's flag names), converted by
     ``cli.convert`` (live and ``--use_ema``; once through ``python -m``)
     and loaded onto the card, every parameter and buffer bit for bit;
     phase 10's dock path from the converted directories. The legacy score
     model at DiffDock's published width (ns=48, nv=10, 6 layers,
     sh_lmax=2) and the legacy all-atom model at phase 6's widths, seeded,
     lm 0, through the same files and converter: each layer's route (the
     edge-list kernel's build with its shared-memory bytes at 24- and
     1-edge lists, or the plain TP), B=2 forwards and a 1-step B=8 ODE sample card against CPU,
     ``cli.infer --old_score_model`` on 1a0q (8 poses x 20 steps, the
     legacy rerank; messages by route, launches against the config, every
     ns=24 layer on a tensor-core build), one sample and rerank recorded and
     every edge-list call replayed (bit for bit across two launches, masked
     edges exactly zero; one step's calls timed), poses/s and the rerank's
     ms; ``cli.confidence_train --affinity_prediction`` with ``--parallel
     2`` (the legacy all-atom model) and with ``--transfer_weights`` (the
     residue-level model's affinity column), on rollouts and near-crystal
     poses: steps' ms and launches, a nonzero training affinity loss, the
     workdir back bit for bit, the affinity validation metrics; one step of
     the affinity model at dropout 0 card against CPU (loss, every
     gradient; a row off the tolerance only at a hidden unit at the ReLU
     where a float64 CPU step sides with one device, at most 4 rows) and
     its training-kernel calls replayed. Every line carries
     the card's name and power limit.
 16. the score-model remainder: phase 5's score model with one field changed
     each, seeded, full width on 1a0q: (A) the all-atom model in score mode
     at lmax=2 with the 3183 seeded atoms and 3 trunk layers (every layout
     of the 5-layer trunk), (B) the residue-level model at lmax=2, (C) the
     second-order irreps ladder at lmax=1 (l = 2 node blocks). Per path: each
     layer's route, builds and shared-memory bytes; a B=1 forward card
     against CPU; a B=32 20-step sample, timed after a warm-up at C, its
     first run at A and B (poses/s; the launches of rec_g, cross_g and the edge-list kernel
     against the config; no plain version called on the card), its poses
     reranked by phase 6's model (ms; A also with ``embed_full_receptor``);
     every kernel call of one sample replayed through kernel and plain
     version (bit for bit across two launches; timed at C, whose rows enter
     the ``kernels`` line); a warm-up and 3 B=16 ``TrainConfig()`` steps
     (median ms, launches against the config) and one step's kernel and op
     calls replayed (timed at C). Then the plain configurations (depthwise,
     3-layer edge MLPs, the side-chain head): a B=1 forward card against CPU,
     a B=16 forward's launches and one training step. Every line carries the
     card's name and power limit.
 17. sh_lmax = 3 (16-wide harmonics; the JAX package's route: every kNN and
     cross group gathers its senders and runs the edge-list kernel, row 7, or
     in training the differentiable edge op, row 11 over row 10; no rec_g,
     cross_g or rec training op): the torsion head's refusal (the JAX
     package's KeyError: 5); (D) phase 5's score model with ``sh_lmax: 3,
     no_torsion: true`` on phase 16's flow (builds, a B=1 forward card
     against CPU, the timed B=32 20-step sample and its launches, the rerank
     by phase 6's model, every call of a sample replayed and timed, 3 B=16
     training steps and one step's calls replayed and timed; every
     edge-list call on a tensor-core build, masked per-edge messages exactly
     zero), a B=2 training step card against CPU (phase 7's check); (E)
     phase 6's confidence architecture at ``sh_lmax: 3`` reranking (D)'s
     poses (phase 6's check: ms, launches, card against CPU on 2, its calls
     replayed); (F) the second-order ladder with ``sh_lmax: 3, no_torsion:
     true`` on phase 16's flow as (D), its replays untimed (the float32 and
     5-wide SHD=16 builds, which only (F) reaches), and a B=2 training step
     card against CPU. Every line carries the card's name and power limit.
 18. data parallel (``parallel/mesh``): (G) ``cli.infer --data_parallel``
     on 1a0q from files (phase 13's set-up, 8 poses x 20 steps) in this
     process at world size 1 over NCCL (torchrun's environment), its
     rmsds.npy against the run without the flag within 1e-4 A or twice that
     run's own spread over reruns, whichever is larger; (H) two
     ranks spawned by the script (``--dp-rank``) on cuda:0 over gloo, which
     load the kernels this process built: phase 7's model at
     ``TrainConfig()`` (B=16, 8 a rank) one step at dropout 0 against the
     same step in this process (loss rtol 1e-4, every gradient element
     within 2e-4 + 2e-3 |value|, parameters after the lr 1e-3 Adam step
     within 2.5e-3, batch statistics), one at dropout 0.1 (finite, its
     launches against the config), phase 5's B=32 sample over the ranks
     (16 a rank) against phase 5's poses within its ``sample_tolerance`` with each rank's
     launches against the config (the per-batch counts), each rank's
     gradient all-reduce ms and poses/s (two ranks share one card: no
     scaling); (I) the same step with the state cut over a (1, 2) data x
     model mesh under (H)'s tolerances, at least one leaf cut; the ranks
     hold the same parameters after every step. Every line carries the
     card's name and power limit.
 19. DockGen scale: three synthetic protein-like complexes
     (``scripts/stress_eval_torch.write_complex``, seeds 0-2; 900, 1800 and
     2800 residues, so the N=1024, 2048 and 3072 receptor buckets, the
     all-atom buckets A=3072 to 12288) with seeded 1280-d embeddings, phase
     5's score model and phase 6's confidence model as model directories,
     through ``cli.infer`` (8 poses x 20 steps, the auto phase plans, the
     all-atom rerank): a warm-up run, then a timed one (the run time per
     receptor bucket); no failure, every artifact written, the cross-cap
     telemetry present; then the N=3072 complex alone: the launches of its
     sample and rerank against the config, every call of them recorded and
     replayed through kernel and plain version (rec, pb, rec_g and cross_g
     bit for bit across two launches; every cross_g call on its tensor-core
     build), timed; its rows enter the ``kernels`` line as ", DockGen
     N=3072". Every line carries the card's name and power limit.
Then the script's wall time with each phase's, one JSON line with every kernel's numbers (launches per 20-step sample
for phase 3's kernels and rows 4, 5 and 6, per confidence forward for phase
6's, per training step for phase 7's and per confidence training step for
phase 12's rec_g with the mask, per sample and per training step of phase
16's path C for the rows named ", path C" and of phase 17's (D) for those
named ", sh_lmax=3 (D)", per evaluator batch (a sample) or rerank of phase
19's N=3072 complex for those named ", DockGen N=3072"; ``bound_ms`` the
tensor-core bound,
``bound_fp32_ms`` the float32 one), and last the device line.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import functools
import json
import os
import re
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
# {library: its kernels that run H x W products on wgmma, by a part of their mangled names}
TC_KERNELS = {"tpconv_rec": ("17tpconv_rec_kernel", "23tpconv_rec_dm_tc_kernel"), "tpconv_pb": ("16tpconv_pb_kernel",),
              "tpconv_cross_rev": ("23tpconv_cross_rev_kernel",),
              "tpconv_rec_g": tuple(f"{k}ILi{shd}ELi{di}E" for k in ("19tpconv_rec_g_kernel", "25tpconv_rec_g_dm_tc_kernel")
                                    for shd in (4, 9) for di in (3, 5)),
              "tpconv_cross": ("22tpconv_cross_tc_kernel",),
              "tpconv_cross_g": tuple(f"24tpconv_cross_g_tc_kernelILi{shd}ELi{di}E" for shd in (4, 9) for di in (3, 5)),
              "tpconv_edge": tuple(f"{k}ILi{shd}ELb{dm}E" for k in ("21tpconv_edge_tc_kernel", "22tpconv_edge_tc5_kernel")
                                   for shd in (4, 9, 16, 20) for dm in (0, 1)),
              "tpconv_bwd": ("25tpconv_bwd_edge_tc_kernel", "26tpconv_bwd_edge_tc5_kernel", "17tn_gemm_tc_kernelILi96ELb0E",
                             "17tn_gemm_tc_kernelILi96ELb1E")}
KERNEL_RTOL = 2e-4  # max |kernel - plain| <= KERNEL_RTOL * max(1, max |plain|)
MODEL_RTOL = 1e-3  # CUDA vs CPU forward, per output, relative to its max |value|
SAMPLE_ATOL = 1e-2  # CUDA vs CPU ligand positions after a 3-step ODE sample, in A
SPREAD_RERUNS = 8  # reruns that measure a sample's own spread on the card (``rerun_tolerance``)
# the most a sample's own spread may reach, in A: a quarter of the 2 A RMSD that decides a docked pose. A spread
# beyond it could change which poses count as docked, and fails whatever its cause
SPREAD_CAP = 0.5
PHASE5_RERUNS = 12  # phase 5's sample, measured once for phases 10, 15 and 18 (its farthest runs are rare)
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

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position

    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM)
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    batch = replicate_complex(host_complex(LM_DIM)[0], B_POSES, device=dev)
    b0 = randomize_position(batch, torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    run, plan = sample_run(model, b0)
    print(f"main path: B={B_POSES}, {STEPS} steps, lm_dim {LM_DIM}, N={batch.rec_pos.shape[1]}, phase plan {plan}",
          flush=True)
    return model, b0, run


def sample_run(model, b0, mesh=None) -> tuple:
    """(phase 5's sample of ``model`` from the poses ``b0`` as a function,
    its phase plan): STEPS steps, the plan PLAN cut to the receptor's
    bucket, the noise drawn from seed 1, so that every run draws the same
    noise and runs the same data as the one phase 3 records; over
    ``mesh``'s ranks when given (phase 18)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig
    from confidence_bootstrapping_tpu_torch.sampler.sampling import sample

    dev = b0.lig_pos.device
    plan = [(s, c) for s, c in PLAN if c < b0.rec_pos.shape[1]]
    scfg = SamplerConfig(inference_steps=STEPS, rec_phase_steps=tuple(s for s, _ in plan),
                         rec_phase_caps=tuple(c for _, c in plan))
    return lambda: sample(model, b0, model.cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev,
                          mesh=mesh), plan


def rerun_tolerance(run, ref, floor: float, what: str, reruns: int = SPREAD_RERUNS) -> float:
    """The tolerance on a result that should equal ``ref``, a result of
    ``run()``: ``floor`` or twice the run's own spread on the card, whichever
    is larger. The spread is the largest distance from ``ref`` of ``reruns``
    reruns (the same inputs and noise): cross_rev's reverse scatter sums with
    atomics in a run-dependent order, and 20 steps carry that rounding, at
    times across a discrete choice (a compaction's residues), so a few runs
    land farther off than the rest. Fails where the spread passes
    SPREAD_CAP: a fault that makes the runs differ cannot widen its own
    tolerance beyond it."""
    dist = [float(np.abs(np.asarray(run(), np.float64) - ref).max()) for _ in range(reruns)]
    tol = max(floor, 2 * max(dist))
    print(f"{what} rerun {reruns} times: {', '.join(f'{d:.3g}' for d in dist)} from its first run; tolerance "
          f"{tol:.3g} (at least {floor}; the spread at most {SPREAD_CAP})", flush=True)
    if max(dist) > SPREAD_CAP:
        fail(f"{what}: its reruns on the card land more than {SPREAD_CAP} A apart")
    return tol


def sample_tolerance(model, b0, final_pos) -> float:
    """``rerun_tolerance`` of phase 5's sample (A; at least SAMPLE_ATOL),
    PHASE5_RERUNS reruns."""
    run = sample_run(model, b0)[0]
    return rerun_tolerance(lambda: run()[0].lig_pos.cpu().numpy(), final_pos.cpu().numpy(), SAMPLE_ATOL,
                           "phase 5's sample", PHASE5_RERUNS)


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


def replay_sample(model, run, what: str, timed: bool = True) -> list:
    """One sample run with the wrappers recorded, its calls checked against
    the launches the config implies, then every call replayed through the
    kernel and its plain version (``replay``; rec and pb bit for bit across
    two launches; both timed with ``timed``). Returns ``replay``'s rows."""
    import torch

    calls = record_calls(run)
    torch.cuda.synchronize()
    counts = {name: len(calls[name]) for name in KERNELS}
    want = {name: n for name, n in expected_launches(model, STEPS).items() if name in KERNELS}
    print(f"recorded {what}: calls {counts}, expected from the config {want}", flush=True)
    if counts != want:
        fail(f"the recorded {what} did not run every TP-conv through its wrapper")
    rows = replay(calls, sample_kernels(), bitwise=("tpconv_rec", "tpconv_pb"), timed=timed)
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


def replay(calls: dict, kernels: dict, rtols: dict = None, bitwise=(), timed: bool = True) -> list:
    """Replay every recorded call through its kernel and its plain version:
    error against the stated tolerance, both timed, both bounds (``bounds``)
    from the call's own data. Prints per shape and as means over the calls;
    returns one JSON row per kernel (without ``launches``). ``rtols``: per
    kernel, a tolerance per output (default KERNEL_RTOL for each), each
    output held to it times max(1, max |its plain value|). The kernels named
    in ``bitwise`` must give the same bits on a second launch. Without
    ``timed`` the checks alone (times nan)."""
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
                ms=cuda_time(lambda: fn(*args, **kwargs), reps=5, warmup=1) if timed else float("nan"),
                plain_ms=cuda_time(lambda: plain(*args), reps=2, warmup=0) if timed else float("nan"),
                bound=b["tc"], bound_fp32=b["fp32"], bound_bytes=b["bytes"], flops=flops, mm=mm))
        every = [m for ms in shapes.values() for m in ms]
        for tag, ms in (list(shapes.items()) if timed else []) + [("all", every)]:
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
    boundaries, card against CPU within ``rerun_tolerance`` of the card's
    own reruns (steps from t=1 move a pose tens of A, and a rounding can
    take a compaction's residues across a tie)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.sampler.sampling import sample

    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM)
    padded = host_complex(LM_DIM)[0]
    pos = padded["lig_pos"][None] + np.random.RandomState(1).randn(2, *padded["lig_pos"].shape).astype(np.float32) * 2
    scfg = SamplerConfig(inference_steps=3, ode=True, rec_phase_steps=(1, 2), rec_phase_caps=(256, 128))
    ref_pos = None
    for device in (dev, torch.device("cpu")):  # the card first: it builds the score-norm tables
        model = TensorProductScoreModel(cfg, device=device, seed=0)
        batch = replicate_complex(padded, 2, device=device).replace(lig_pos=torch.as_tensor(pos, device=device))
        out = model(batch.set_time(0.5, 0.5, 0.5))
        final, _ = sample(model, batch, cfg, scfg, device=device)
        if ref_pos is None:
            torch.cuda.synchronize()
            got = [t.cpu() for t in out[:3]]  # tr, rot, tor (sidechain_pred: None)
            ref_pos = final.lig_pos.cpu()
            tol = rerun_tolerance(lambda: sample(model, batch, cfg, scfg, device=device)[0].lig_pos.cpu().numpy(),
                                  ref_pos.numpy(), SAMPLE_ATOL, "the card's 3-step sample")
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
        print(f"3-step ODE sample with compaction: max_abs_err {err:.3g} A (tolerance {tol:.3g} A), poses moved "
              f"{moved:.3g} A", flush=True)
        if not (err <= tol and moved > 0.1):
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
    timed sample, its final ligand positions [B, L, 3], its poses/s)."""
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
    return launches, pos, B_POSES / secs


def profile_run(run, timed_ms: float, host_ops: bool = True):
    """One more run under torch.profiler: device time by kernel and the
    device's idle share of the wall time, of this run and of the unprofiled
    timed run (same kernels, less host overhead). A measurement, not a check.
    Without ``host_ops`` the host's operators are not traced (the device's
    events alone: a long run's trace is read in far less time). Returns the
    idle share of the unprofiled run, or None without device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    if not dev_events:
        print(f"profile: wall {wall_ms:.1f} ms; torch.profiler recorded no device time", flush=True)
        return None
    print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f} "
          f"(of the unprofiled run's {timed_ms:.1f} ms: {1 - busy_ms / timed_ms:.3f}); device time by kernel:",
          flush=True)
    for e in dev_events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:90]}")
    rest = dev_events[12:]
    print(f"  {sum(e.self_device_time_total for e in rest) / 1e3:9.2f} ms  {sum(e.count for e in rest):5d}x  "
          f"{len(rest)} other kernels", flush=True)
    return 1 - busy_ms / timed_ms


def expected_conf_launches(model) -> dict:
    """Kernel launches of one confidence forward: per embedding layer and
    per trunk layer but the last, the receptor and atom kNN groups on rec_g;
    per trunk layer, the ligand <- receptor and ligand <- atom groups on
    cross_g. On the "edge" route (sh_lmax=3) each of these groups gathers
    its senders and runs the edge-list kernel instead."""
    rec, cross = 2 * (len(model.rec_emb_layers) + len(model.conv_layers) - 1), 2 * len(model.conv_layers)
    if model.conv_layers[0].route == "edge":
        return {"tpconv_edge": rec + cross}
    return {"tpconv_rec_g": rec, "tpconv_cross_g": cross}


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


def rerank_check(model, padded: dict, poses, what: str, timed: bool = True) -> tuple:
    """A confidence model's rerank of ``poses`` [B, L, 3] on the card
    (``score_confidence`` on ``padded`` replicated B times): a warm-up, the
    timed rerank (launches against ``expected_conf_launches``, no plain
    version called), the card against the CPU on 2 of the poses within
    MODEL_RTOL, then every kernel call of the rerank recorded and replayed
    through kernel and plain version (bit for bit, masked per-edge messages
    exactly zero; timed with ``timed``). Every layer of the ns=24 model takes
    the tensor cores for its cross lists, and on the "edge" route for every
    list. -> (the rerank as a function, its confidences, its seconds, the
    launches of its kernels, the replay's JSON rows)."""
    import torch

    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

    batch = replicate_complex(padded, len(poses), device=poses.device)
    run = lambda: score_confidence(model, batch, lig_pos=poses)  # noqa: E731
    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    conf, launches, plain = counted_all(run)
    secs = time.perf_counter() - t0
    names = tuple(expected_conf_launches(model))
    want = {name: 0 for name in all_counters()}
    want.update(expected_conf_launches(model))
    print(f"{what}: rerank of {len(poses)} poses: warm-up {warm:.3f} s, timed {secs:.4f} s ({secs * 1e3:.1f} ms, "
          f"{len(poses) / secs:.3f} poses/s); confidences {conf.min().item():.4f} to {conf.max().item():.4f}; "
          f"launches {nonzero(launches)}, expected from the config {nonzero(want)}; plain versions called {plain}",
          flush=True)
    if launches != want or any(plain.values()):
        fail(f"{what}: the rerank did not run every TP-conv through its kernel")
    if conf.shape != (len(poses),) or not torch.isfinite(conf).all():
        fail(f"{what}: confidences are not finite")
    ref = score_confidence(get_model(model.cfg, device="cpu", seed=0), replicate_complex(padded, 2, device="cpu"),
                           lig_pos=poses[:2].cpu())
    err, peak = (conf[:2].cpu() - ref).abs().max().item(), ref.abs().max().item()
    print(f"{what}: card vs CPU on 2 poses: max_abs_err {err:.3g} (max |cpu| {peak:.3g}, tolerance {MODEL_RTOL} x "
          f"max(1, max |cpu|))", flush=True)
    if not err <= MODEL_RTOL * max(1.0, peak):
        fail(f"{what}: the card disagrees with the CPU")

    raw = record_calls(run, names)
    torch.cuda.synchronize()
    calls = edge_calls(raw) if "tpconv_edge" in raw else raw
    tc = "tpconv_edge" if "tpconv_edge" in raw else "tpconv_cross_g"
    check_tc_builds({tc: calls[tc]}, what)
    check_masked_messages([c for c in raw.get("tpconv_edge", ()) if not c[1].get("sum_k", True)])
    with torch.no_grad():
        rows = replay(calls, {k: v for k, v in remainder_kernels().items() if k in names}, bitwise=names, timed=timed)
    return run, conf, secs, {k: launches[k] for k in names}, rows


def confidence_phase(dev, final_pos) -> tuple:
    """Phase 6: the confidence rerank (see the module docstring). Returns
    (the replay's JSON rows, the launches of the timed forward, (the
    confidence model, its B_POSES batch of 1a0q, the confidences of phase
    5's poses) for phases 8 and 10)."""
    from confidence_bootstrapping_tpu_torch.config import confidence_model_config
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel, compact_crop
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
    conf = conf_sampled = score_confidence(model, batch, lig_pos=final_pos.to(dev)).cpu().numpy()
    order = np.argsort(-np.nan_to_num(conf, nan=-1e9))
    print(f"rerank of phase 5's {len(conf)} poses: top confidences "
          f"{', '.join(f'pose {i}: {conf[i]:.4f}' for i in order[:5])}", flush=True)
    if conf.shape != (B_POSES,) or not np.isfinite(conf).all():
        fail("confidences of the sampled poses are not finite")

    # the timed forward, on poses near the crystal pose
    poses = near_crystal_poses(padded, B_POSES).to(dev)
    stats = compact_crop(batch.replace(lig_pos=poses), None, float(cfg.crop_beyond), cfg.crop_res_cap,
                         cfg.crop_atom_cap)[2]
    st = {k: v.cpu().numpy() for k, v in stats.items()}
    print(f"crop per pose: kept residues {st['kept_res'].min()}-{st['kept_res'].max()} (overflow "
          f"{st['res_overflow'].max()}), kept atoms {st['kept_atoms'].min()}-{st['kept_atoms'].max()} (overflow "
          f"{st['atom_overflow'].max()})", flush=True)
    run, _, secs, launches, rows = rerank_check(model, padded, poses, "confidence forward")
    profile_run(run, secs * 1e3)
    return rows, launches, (model, batch, conf_sampled)


# ---------------------------------------------------------------------------- phase 7: training


TRAIN_STEPS, EVAL_DRAWS = 5, 8  # the timed steps' batch is TrainConfig().batch_size
SUM_RTOL = 1e-3  # weight gradients: sums over every edge of a call, in another order than the plain version's
RELU_GUARD = 1e-5  # a hidden pre-activation within this of zero, relative to sum |z w1| + |b1|, is "at the ReLU"
TRAIN_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "tpconv_edge": ("csrc/tpconv_edge.cu", "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:303"),
    "tpconv_rec_dm": ("csrc/tpconv_rec.cu", "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:457"),
    "tpconv_rec_g_dm": ("csrc/tpconv_rec_g.cu", "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:457"),
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
    call them. rec with the mask is ``tpconv_rec_dm`` at lmax=1 and
    ``tpconv_rec_g_dm`` at lmax=2."""
    from confidence_bootstrapping_tpu_torch.models import layers
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_train as tt

    calls = {name: [] for name in list(TRAIN_KERNELS) + list(TRAIN_OPS) + ["bwd_kind"]}
    orig = {"edge": tt.fused_tpconv_edge, "rec": tt.fused_tpconv_rec, "rec_g": tt.fused_tpconv_rec_g,
            "bwd": tt.edge_bwd, "op": layers.fused_tpconv_train, "rec_op": layers.fused_tpconv_rec_train,
            "rec_bwd": tt._RecTrain.backward}

    def edge(*a, dmask=None, sum_k=True, packed=None):
        calls["tpconv_edge"].append((a + (dmask, sum_k), {}))
        return orig["edge"](*a, dmask=dmask, sum_k=sum_k, packed=packed)

    def rec(*a, packed=None, dmask=None):
        calls["tpconv_rec_dm"].append((a + (dmask,), {}))
        return orig["rec"](*a, packed=packed, dmask=dmask)

    def rec_g(*a, packed=None, dmask=None):
        calls["tpconv_rec_g_dm"].append((a + (dmask,), {}))
        return orig["rec_g"](*a, packed=packed, dmask=dmask)

    kind = []  # set while the receptor op's backward runs: its edge backward is a receptor group's

    def bwd(*a, **kw):
        calls["tpconv_bwd"].append((a, kw))
        calls["bwd_kind"].append("receptor group" if kind else "edge list")
        return orig["bwd"](*a, **kw)

    def rec_backward(ctx, g):
        kind.append(1)
        try:
            return orig["rec_bwd"](ctx, g)
        finally:
            kind.pop()

    def op(*a, **kw):
        calls["fused_tpconv_train"].append((a, kw))
        return orig["op"](*a, **kw)

    def rec_op(*a, **kw):
        calls["fused_tpconv_rec_train"].append((a, kw))
        return orig["rec_op"](*a, **kw)

    try:
        tt.fused_tpconv_edge, tt.fused_tpconv_rec, tt.fused_tpconv_rec_g, tt.edge_bwd = edge, rec, rec_g, bwd
        layers.fused_tpconv_train, layers.fused_tpconv_rec_train = op, rec_op
        tt._RecTrain.backward = staticmethod(rec_backward)
        run()
    finally:
        tt.fused_tpconv_edge, tt.fused_tpconv_rec, tt.edge_bwd = orig["edge"], orig["rec"], orig["bwd"]
        tt.fused_tpconv_rec_g = orig["rec_g"]
        layers.fused_tpconv_train, layers.fused_tpconv_rec_train = orig["op"], orig["rec_op"]
        tt._RecTrain.backward = staticmethod(orig["rec_bwd"])
    return calls


def replay_train_ops(calls: dict, timed: bool = True) -> list:
    """Rows 11 and 12: every recorded call of the two autograd ops, forward
    and backward against a random cotangent, through the kernels and through
    autograd of the plain composition on the card: outputs and every
    gradient against the stated tolerances, both timed. Bound: the sum of
    the call's forward and backward bounds."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge, tpconv_g, tpconv_rec, tpconv_train as tt
    from confidence_bootstrapping_tpu_torch.ops.graph_builders import gather_nodes

    def rec_plain(a, dmask):  # the receptor op's plain version at its harmonics
        if a[11] == SH2:
            return tpconv_g.tpconv_rec_g_plain(*a[:14], dmask)
        return tpconv_rec.tpconv_rec_plain(*a[:10], a[10], a[12], a[13], dmask)

    rows = []
    for name, replaces in TRAIN_OPS.items():
        if not calls[name]:  # a ligand-only (torsional) step has no receptor op
            continue
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
                plain = lambda a: rec_plain(a, kw.get("dmask"))
                mask, H = args[5], args[8].shape[0]
                ir = (args[10], args[11], args[12])
                F = args[3].shape[-1] + 2 * args[13]
                fwd_flops, fwd_mm, _ = rec_work(tuple(args[:14]))
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
                           ms=cuda_time(lambda: fwd_bwd(kernel, cot), reps=3, warmup=1) if timed else float("nan"),
                           plain_ms=cuda_time(lambda: fwd_bwd(plain, cot), reps=1, warmup=0) if timed else float("nan")))
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


def edge_builds(calls: dict) -> dict:
    """{kernel: {build: calls}}: the build (``tensor cores``, or ``float32 at``
    64 or 32 edges a chunk) that each recorded call of the edge-list kernel
    (rows 5-7), of rec and rec_g with the dropout mask and of the cross
    kernels (rows 4 and 9) ran, as its wrapper picks it
    (``tpconv_edge.edge_build``, ``tpconv_rec.rec_build``,
    ``tpconv_g.rec_g_build``, ``tpconv_g.cross_build``)."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge, tpconv_g, tpconv_rec

    def name(tc_cm):
        return "tensor cores" if tc_cm[0] else f"float32 at {tc_cm[1]}"

    out = {}
    for kernel in ("tpconv_edge", "tpconv_nbr", "tpconv_msgs", "tpconv_rec_dm", "tpconv_rec_g_dm", "tpconv_cross",
                   "tpconv_cross_g"):
        for a, _ in calls.get(kernel, ()):
            if kernel in ("tpconv_cross", "tpconv_cross_g"):  # row 4 names no harmonics: lmax=1
                ir_in, sh, ir_out, ns = (a[11], SH1, a[12], a[13]) if kernel == "tpconv_cross" else a[11:15]
                b = tpconv_g.cross_build(kernel, ir_in, ir_out, sh, a[5].shape[-1], ns, a[9].shape[0], a[4].shape[2])
            elif kernel == "tpconv_rec_dm":
                b = tpconv_rec.rec_build(a[10], a[11], a[3].shape[-1], a[12], a[8].shape[0], True)
            elif kernel == "tpconv_rec_g_dm":
                b = tpconv_g.rec_g_build(a[10], a[11], a[12], a[3].shape[-1], a[13], a[8].shape[0], True)
            else:  # the training calls name their harmonics; rows 5 and 6 take lmax=1
                sh, ir_out = (a[9], a[10]) if kernel == "tpconv_edge" else (SH1, a[9])
                b = tpconv_edge.edge_build(a[8], sh, ir_out, a[0].shape[-1], a[6].shape[0], a[0].shape[1])
            out.setdefault(kernel, {}).setdefault(name(b), 0)
            out[kernel][name(b)] += 1
    return out


def check_tc_builds(calls: dict, what: str) -> None:
    """Prints ``edge_builds`` and fails unless every call ran a tensor-core
    kernel (the score model's ns=32 ladder and the confidence model's ns=24
    one: every layer fits the stage)."""
    builds = edge_builds(calls)
    print(f"{what}: builds {builds}", flush=True)
    if any(set(b) != {"tensor cores"} for b in builds.values()):
        fail(f"{what}: a call of the ns=32 or ns=24 ladder ran a float32 build")


def replay_train_kernels(calls: dict, timed: bool = True) -> list:
    """The training kernels' recorded calls (``record_train_calls``) replayed
    through kernel and plain version; the edges at the ReLU
    (``near_relu_boundary``) get no cotangent in the backward's replay.
    Returns their JSON rows. Without ``timed`` the checks alone (no times,
    no stage profile of the edge backward)."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_edge, tpconv_g, tpconv_rec

    guarded = 0
    for i, (a, kw) in enumerate(calls["tpconv_bwd"]):
        near = near_relu_boundary(a[0], a[5], a[6])
        guarded += int((near & (a[3] != 0).any(-1)).sum())
        calls["tpconv_bwd"][i] = (a[:3] + (a[3] * ~near[:, None],) + a[4:], kw)
    print(f"edge backward replay: {guarded} edges at the ReLU left out", flush=True)
    kinds = iter(calls["bwd_kind"])  # replay() calls the work function once per call, in call order

    def bwd_kind_work(args):
        flops, mm, tag = bwd_work(args)
        return flops, mm, f"{next(kinds)}: {tag}"

    kernels = {
        "tpconv_edge": (lambda *a: tpconv_edge.fused_tpconv_edge(*a[:11], dmask=a[11], sum_k=a[12]),
                        tpconv_edge.tpconv_edge_plain, edge_work, TRAIN_KERNELS["tpconv_edge"][1]),
        "tpconv_rec_dm": (lambda *a: tpconv_rec.fused_tpconv_rec(*a[:13], dmask=a[13]), tpconv_rec.tpconv_rec_plain,
                          lambda a: rec_work(a[:13]), TRAIN_KERNELS["tpconv_rec_dm"][1]),
        "tpconv_rec_g_dm": (lambda *a: tpconv_g.fused_tpconv_rec_g(*a[:14], dmask=a[14]), tpconv_g.tpconv_rec_g_plain,
                            lambda a: rec_work(a[:14]), TRAIN_KERNELS["tpconv_rec_g_dm"][1]),
        "tpconv_bwd": (tpconv_bwd.edge_bwd, tpconv_bwd.edge_bwd_plain, bwd_kind_work,
                       TRAIN_KERNELS["tpconv_bwd"][1]),
    }
    kernels = {name: k for name, k in kernels.items() if calls[name]}  # rec with the mask at one lmax a model
    with torch.no_grad():
        rows = replay(calls, kernels, rtols={"tpconv_bwd": (KERNEL_RTOL,) * 3 + (SUM_RTOL,) * 4},
                      bitwise=("tpconv_bwd", "tpconv_edge", "tpconv_rec_dm", "tpconv_rec_g_dm"), timed=timed)
        for r in rows:
            r["source"] = "confidence_bootstrapping_tpu_torch/" + TRAIN_KERNELS[r["name"]][0]
            if r["name"] == "tpconv_bwd" and timed:
                r.update(bwd_stages(calls["tpconv_bwd"]))
            elif r["name"] == "tpconv_bwd":
                check_masked_edges(calls["tpconv_bwd"])
    return rows


def check_masked_edges(bwd_calls: list) -> None:
    """Fails unless the edge backward gives every edge marked masked exact zeros."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd

    for a, kw in bwd_calls:
        valid = kw.get("valid")
        if valid is not None and not all(bool((t[~valid] == 0).all()) for t in tpconv_bwd.edge_bwd(*a, **kw)[:3]):
            fail("the edge backward gave a masked edge a gradient")


def bwd_stages(bwd_calls: list) -> dict:
    """Row 10's device time by stage over one pass of the recorded calls
    (torch.profiler), in mean ms a call: the per-edge kernel, the dh product,
    the MLP backward, the weight-gradient reduction (its products and the
    slices' sum) and the rest (the wrapper's numbering of the valid edges,
    packing and zeroing); and beside the reduction its library yardstick,
    torch.matmul of [h | 1]^T d_w and [z | 1]^T dh at float32 "highest"
    precision over each call's valid edges (d_w and dh random: a dense
    product's time does not depend on the values), and the reduction's two
    bounds over those edges (``bounds``: 2 (H + 1) W + 2 (F + 1) H flops an
    edge, all of them matrix products; h, d_w, z and dh read once, dW2, db2,
    dW1 and db1 written once). Checks that the edges marked masked got exact
    zeros. Returns the row's extra keys."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd

    check_masked_edges(bwd_calls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a, kw in bwd_calls:
            tpconv_bwd.edge_bwd(*a, **kw)
        torch.cuda.synchronize()
    stages = dict(per_edge=0.0, dh=0.0, mlp=0.0, reduction=0.0, other=0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        k, t = e.key, e.self_device_time_total / 1e3 / len(bwd_calls)
        product = re.search(r"tn_gemm_tc_kernel<\d+, (true|false)>", k)  # <BN, PART>: PART, the weight products
        stage = ("per_edge" if "tpconv_bwd_edge" in k else "mlp" if "mlp_bwd_kernel" in k
                 else ("reduction" if product.group(1) == "true" else "dh") if product
                 else "reduction" if "sum_splits" in k else "other")
        stages[stage] += t
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    lib, valid_edges, red_tc, red_fp32 = [], [], [], []
    for a, kw in bwd_calls:
        attr, g, dm, w1, b1, w2 = a[0], a[3], a[4], a[5], a[6], a[7]
        valid = kw.get("valid")
        valid = (g != 0).any(-1) if valid is None else valid
        z = attr[valid]
        h = torch.relu(z @ w1 + b1) * (1.0 if dm is None else dm[valid])
        one = torch.ones(len(z), 1, device=z.device)
        hc, zc = torch.cat([h, one], 1), torch.cat([z, one], 1)
        dw, dh = torch.randn(len(z), w2.shape[1], device=z.device), torch.randn(len(z), w2.shape[0], device=z.device)
        lib.append(cuda_time(lambda: (torch.matmul(hc.t(), dw), torch.matmul(zc.t(), dh)), reps=3, warmup=1))
        valid_edges.append(len(z))
        n, F, (H, W) = len(z), attr.shape[1], w2.shape
        mm = 2 * n * ((H + 1) * W + (F + 1) * H)
        b = bounds(4 * (n * (2 * H + W + F) + (H + 1) * W + (F + 1) * H), mm, mm)
        red_tc.append(b["tc"])
        red_fp32.append(b["fp32"])
    torch.set_float32_matmul_precision(prec)
    lib_ms, bound_tc, bound_fp32 = float(np.mean(lib)), float(np.mean(red_tc)), float(np.mean(red_fp32))
    print(f"edge backward by stage (torch.profiler, mean ms a call over {len(bwd_calls)} calls, "
          f"{np.mean(valid_edges):.0f} valid edges a call): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; the reduction's library yardstick, torch.matmul of [h | 1]^T d_w and [z | 1]^T dh at 'highest': "
          f"{lib_ms:.4f} ms; the reduction's bound {bound_tc:.4f} ms tensor cores, {bound_fp32:.4f} ms float32",
          flush=True)
    return {"stage_ms": stages, "reduction_ms": stages["reduction"], "reduction_library_ms": lib_ms,
            "reduction_bound_ms": bound_tc, "reduction_bound_fp32_ms": bound_fp32}


def step_card_vs_cpu(dev, cfg0, padded, what: str) -> None:
    """One training step of the score model of ``cfg0`` (seed 0, dropout 0)
    at B=2 on ``padded``, the noise drawn once on the card: its loss, every
    gradient and the batch statistics it leaves, card against CPU, each
    within MODEL_RTOL x max(1, max |cpu|)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.train import diffusion, losses

    tcfg = TrainConfig()
    draws = None
    res = []
    for device in (dev, torch.device("cpu")):  # the card first: it builds the so3/torus tables
        model = get_model(cfg0, device=device, seed=0)
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
    print(f"{what} card vs CPU (B=2, dropout 0): loss {lg.item():.6f} vs {lc.item():.6f}; "
          f"{len(gc)} gradients and {len(bc)} batch statistics; worst error {worst[0]:.3g} of its tolerance "
          f"({MODEL_RTOL} x max(1, max |cpu|)) at {worst[1]}", flush=True)
    if not (worst[0] <= 1.0 and torch.isfinite(lg)):
        fail(f"{what}: the card disagrees with the CPU")


def train_phase(dev) -> tuple:
    """Phase 7: training steps of the full-width score model (see the module
    docstring). Returns (JSON rows, launches per step by kernel)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.train import train_loop

    padded = host_complex(LM_DIM)[0]
    tcfg = TrainConfig()

    # the card against the CPU: one step's loss, gradients and batch statistics at dropout 0
    step_card_vs_cpu(dev, ScoreModelConfig(lm_embedding_dim=LM_DIM, dropout=0.0), padded, "training step")

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
    check_tc_builds(calls, "training step")
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

    conf_model, conf_batch, _ = rerank
    out = {}
    t0 = time.perf_counter()
    rerank_calls = record_calls(lambda: out.update(conf=score_confidence(conf_model, conf_batch, lig_pos=final.lig_pos)),
                                ("tpconv_cross_g",))
    conf = out["conf"].cpu().numpy()
    t_conf = time.perf_counter() - t0
    check_tc_builds(rerank_calls, "evaluator rerank")

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
        res.append(([t.cpu() for t in fwd[:3]], final.lig_pos.cpu()))
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
B_WIDE_CHECK, STEPS_WIDE_CHECK = 4, 3  # the card-against-CPU sample at the wide ladder


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
    fn = build.load("tpconv_bwd").cbt_bwd_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 8, ctypes.c_longlong
    for a, b, sh, ns in cases:
        lay = tc.tp_layout(a, b, sh)
        args = (3 * ns, 3 * ns, lay.din, tc.sh_dim(sh), lay.dout, lay.n_x, len(lay.cg),
                len(tpconv_bwd.bwd_layout(a, b, sh).vtab))
        if fn(*args) != tpconv_bwd.bwd_tc_smem_bytes(*args):
            fail(f"tpconv_bwd: {fn(*args)} bytes of shared memory on the tensor-core build at {a} -> {b}, the host "
                 f"mirror says {tpconv_bwd.bwd_tc_smem_bytes(*args)}")
        n += 1
    static = build.load("tpconv_bwd").cbt_bwd_tc_static_bytes
    static.argtypes, static.restype = [], ctypes.c_longlong
    if static() != tpconv_bwd.BWD_TC_STATIC:
        fail(f"tpconv_bwd: the tensor-core kernel has {static()} bytes of static shared memory, the host mirror "
             f"says {tpconv_bwd.BWD_TC_STATIC}")
    return n + 1


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
    print(f"wide training step: builds {edge_builds(calls)}", flush=True)
    replay_train_kernels(calls, timed=False)  # the checks; the kernels line times phase 7's
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
    replay_sample(model, run, "wide sample", timed=False)  # the checks; phase 3 times the kernels
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


# ---------------------------------------------------------------------------- phase 10: serve from model directories


MODEL_DIRS = os.path.join(ROOT, "build", "model_dirs")  # written and removed by phase 10


def state_equal(a, b) -> bool:
    """Every parameter and buffer of two modules: the same names, the same bits."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k].to(sa[k].device)) for k in sa)


def model_dir_phase(dev, model, b0, final_pos, rerank, pos_tol: float) -> None:
    """Phase 10: the dock path from files. Phase 5's score model and phase
    6's confidence model saved as model directories (``save_model_dir``:
    model_config.yml and a Flax msgpack bundle), loaded back onto the card
    with ``cli.dock.load_or_init_model`` (every parameter and buffer bit for
    bit), a config the port does not implement refused, then phase 5's
    sample (its poses, plan and noise) and the rerank from the loaded models,
    timed once, with every kernel's launches against the config and every
    cross_g call on its tensor-core build; the poses held against phase 5's
    within ``pos_tol`` (``sample_tolerance``: cross_rev sums with atomics)
    and the confidences against phase 6's of phase 5's poses within
    MODEL_RTOL."""
    import shutil

    import torch

    from confidence_bootstrapping_tpu_torch import yaml_io
    from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    conf_model = rerank[0]
    shutil.rmtree(MODEL_DIRS, ignore_errors=True)
    try:
        loaded = {}
        for name, m in (("score", model), ("confidence", conf_model)):
            d = os.path.join(MODEL_DIRS, name)
            t0 = time.perf_counter()
            checkpoints.save_model_dir(d, m.cfg, m)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded[name], cfg = load_or_init_model(d, "last_model", device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            same = state_equal(m, loaded[name]) and cfg == m.cfg
            print(f"model dir {name}: {size} bytes ({len(m.state_dict())} tensors), save {t_save * 1e3:.1f} ms, load "
                  f"onto the card {t_load * 1e3:.1f} ms; parameters and buffers bit for bit: {same}", flush=True)
            if not same:
                fail(f"the {name} model directory did not load back bit for bit")

        bad = os.path.join(MODEL_DIRS, "unsupported")
        os.makedirs(bad)
        with open(os.path.join(MODEL_DIRS, "score", checkpoints.CONFIG_NAME)) as f:
            fields = yaml_io.load(f.read())
        with open(os.path.join(bad, checkpoints.CONFIG_NAME), "w") as f:
            f.write(yaml_io.dump(dict(fields, sh_lmax=3)))
        try:
            load_or_init_model(bad, "last_model", device=dev)
            fail("a model_config.yml with sh_lmax: 3 was not refused")
        except ValueError as e:
            print(f"sh_lmax: 3 refused: {e}", flush=True)
    finally:
        shutil.rmtree(MODEL_DIRS, ignore_errors=True)
    dock_from(loaded["score"], loaded["confidence"], b0, final_pos, rerank, "the model directories", pos_tol)


def dock_from(score, conf_model, b0, final_pos, rerank, what: str, pos_tol: float) -> None:
    """Phase 5's sample (its poses, plan and noise) and the rerank from
    loaded models, timed once: every kernel's launches against the config,
    every cross_g call on its tensor-core build, the poses against phase 5's
    within ``pos_tol`` (``sample_tolerance``) and the confidences against
    phase 6's (of phase 5's poses) within MODEL_RTOL."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

    _, conf_batch, conf_want = rerank
    dev = b0.lig_pos.device
    run = sample_run(score, b0)[0]
    counters = {"tpconv_rec_g": tpconv_g.fused_tpconv_rec_g, "tpconv_cross_g": tpconv_g.fused_tpconv_cross_g}
    out = {}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    (final, _), launches = counted(run)
    calls = record_calls(lambda: out.update(conf=score_confidence(conf_model, conf_batch, lig_pos=final.lig_pos)),
                         ("tpconv_cross_g",))
    conf = out["conf"].cpu().numpy()
    order = np.argsort(-np.nan_to_num(conf, nan=-1e9))
    secs = time.perf_counter() - t0
    launches.update({name: fn.launches for name, fn in counters.items()})
    want = dict(expected_launches(score, STEPS), **expected_conf_launches(conf_model))
    err = (final.lig_pos - final_pos.to(dev)).abs().max().item()
    conf_err, peak = float(np.abs(conf - conf_want).max()), float(np.abs(conf_want).max())
    print(f"dock path from {what}: sample and rerank of {B_POSES} poses {secs:.4f} s, "
          f"{B_POSES / secs:.3f} poses/s; top confidences "
          f"{', '.join(f'pose {i}: {conf[i]:.4f}' for i in order[:5])}; launches {launches}; expected from the "
          f"config {want}", flush=True)
    print(f"against the in-memory models: poses max_abs_err {err:.3g} A (tolerance {pos_tol:.3g} A), confidences "
          f"max_abs_err {conf_err:.3g} (max |in memory| {peak:.3g}, tolerance {MODEL_RTOL} x max(1, max |in memory|))",
          flush=True)
    check_tc_builds(calls, f"dock path rerank from {what}")
    if launches != want:
        fail(f"the dock path from {what} did not run every TP-conv through its kernel")
    if not (err <= pos_tol and conf_err <= MODEL_RTOL * max(1.0, peak) and np.isfinite(conf).all()):
        fail(f"the dock path from {what} disagrees with the in-memory models")


# ---------------------------------------------------------------------------- phase 11: the CB loop


CB_SEED = 21  # the loop's generator; the cutoff's round draws from the same seed
CB_EPOCHS, CB_SAMPLES, CB_BATCH, CB_FIXED = 2, 8, 16, 100  # fixed_length 100 / batch 16: 6 fine-tune steps an epoch
RMSD_CPU_ATOL = 1e-5  # the loop's symmetry RMSDs against the CPU's, in A
CB_DIR = os.path.join(ROOT, "build", "cb")  # the loop's workdir, a train-state bundle and an offline cache; removed


class Tagged:
    """A stdout that ends every line with the card's name and power limit."""

    def __init__(self, out, tag: str):
        self.out, self.tag, self.buf = out, tag, ""

    def write(self, text: str) -> int:
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.out.write(f"{line} [{self.tag}]\n" if line.strip() else "\n")
        return len(text)

    def flush(self) -> None:
        self.out.flush()


def all_counters() -> dict:
    """name -> (wrapper, attribute) of every kernel launch counter."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g

    out = {name: (fn, "launches") for name, fn in score_counters().items()}
    out.update(tpconv_rec_g=(tpconv_g.fused_tpconv_rec_g, "launches"),
               tpconv_rec_g_dm=(tpconv_g.fused_tpconv_rec_g, "dm_launches"),
               tpconv_cross_g=(tpconv_g.fused_tpconv_cross_g, "launches"))
    out.update(train_counters())
    return out


def read_counters() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in all_counters().items()}


def launch_diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def cb_confidence_fn(conf_model, record: list = None):
    """The CB CLI's confidence function (``cli/finetune.py:147-157``): the
    target replicated, the poses set, ``score_confidence``; each call's
    poses and confidences appended to ``record``, and its launches."""
    import torch

    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence

    def fn(target, poses):
        before = read_counters()
        batch = replicate_complex(target.padded, len(poses), device=poses.device)
        lp = batch.lig_pos.clone()
        lp[:, : poses.shape[1]] = poses
        conf = score_confidence(conf_model, batch, lig_pos=lp)
        torch.cuda.synchronize()
        if record is not None:
            record.append(dict(poses=poses.clone(), conf=conf.clone(), launches=launch_diff(before, read_counters())))
        return conf

    return fn


def snapshot(state) -> tuple:
    """Copies of a TrainState's parameters, buffers, EMA, Adam state and step."""
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {n: b.clone() for n, b in state.model.named_buffers()},
            {n: e.clone() for n, e in state.ema.items()},
            {n: {k: v.clone() for k, v in state.optimizer.state.get(p, {}).items()}
             for n, p in state.model.named_parameters()},
            state.step, state.lr_scale)


def same_snapshot(a: tuple, b: tuple) -> bool:
    import torch

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        return torch.equal(x, y.to(x.device)) if torch.is_tensor(x) else x == y

    return all(same(x, y) for x, y in zip(a, b))


def load_weights(model, params: dict, buffers: dict):
    """``model`` with ``params`` and ``buffers`` copied in (``copy_`` under
    no_grad, so each weight's version moves); returns it."""
    import torch

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
        for n, b in model.named_buffers():
            b.copy_(buffers[n])
    return model


def tpconvs(model) -> list:
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    return [m for m in model.modules() if isinstance(m, TPConv)]


def stale_packs(model) -> tuple:
    """(stale, packs): how many of the model's cached TP-conv weight packs
    differ, bit for bit, from a pack made now of the edge MLP's weights,
    out of how many there are."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import pack_weights

    stale = packs = 0
    for m in tpconvs(model):
        for (group, sh), (_, packed, _) in m._packed.items():
            now = pack_weights(*m.mlp_weights(group), m.in_irreps, m.out_irreps, sh)
            stale += not all(torch.equal(a, b) for a, b in zip(packed, now))
            packs += 1
    return stale, packs


def keep_stale_packs(model) -> None:
    """Make each cached TP-conv pack look current to ``packed_weights``
    while it holds the weights it was made from: the fault a weight copy
    that leaves the versions as they were would make."""
    for m in tpconvs(model):
        for (group, sh), (_, packed, weights) in list(m._packed.items()):
            key = tuple((w.data_ptr(), w._version) for w in m.mlp_weights(group))
            m._packed[(group, sh)] = (key, packed, weights)


def cb_phase(dev, conf_model, card: str) -> None:
    """Phase 11: the Confidence Bootstrapping loop (``bootstrapping/
    finetune.inference_finetune``) at full width: phase 5's score model
    (seed 0) rolls out 8 poses of 1a0q (the all-atom bucket, seeded atoms)
    per round, phase 6's confidence model filters them at a cutoff set to
    the median confidence of a round drawn with the loop's first seed, the
    buffer keeps at most 5, and each epoch fine-tunes on 6 batches of 16
    from it; 2 epochs, a rollout round each, epoch 1's from the EMA weights.
    Checks: no failed round and the cutoff applied; every kernel's launches
    per round, confidence call and fine-tune step against the config, and
    over the whole loop; the rollout model against a fresh model loaded with
    the EMA and the training model's buffers, its TP-conv packs against
    packs made now of its weights, and a control that keeps epoch 0's
    packs (the stale-pack fault); epoch 1's rollout and one
    fine-tune step replayed through kernel and plain version on the moved
    weights; a round's confidences and RMSDs against the CPU; the workdir's
    msgpack files and a train-state bundle back bit for bit, one more step
    from the loaded state; the offline cache written and read back. Then
    one more epoch under torch.profiler. Every line printed carries ``card``."""
    import contextlib
    import shutil

    with contextlib.redirect_stdout(Tagged(sys.stdout, card)):
        shutil.rmtree(CB_DIR, ignore_errors=True)
        try:
            cb_run(dev, conf_model)
        finally:
            shutil.rmtree(CB_DIR, ignore_errors=True)


def cb_run(dev, conf_model) -> None:
    import dataclasses

    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping import finetune, offline_dataset
    from confidence_bootstrapping_tpu_torch.config import CBConfig, ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.eval import rmsd
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler.sampling import score_confidence
    from confidence_bootstrapping_tpu_torch.train import checkpoints, train_loop

    marks = [("start", time.perf_counter())]
    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM)
    model = get_model(cfg, device=dev, seed=0)
    _, hc, mol = host_complex(LM_DIM, all_atoms=True)
    target = finetune.CBTarget(hc, mol, lm_dim=LM_DIM)
    cb = CBConfig(n_epochs=CB_EPOCHS, cb_inference_freq=1, initial_iterations=1, inference_iterations=1,
                  inference_samples=CB_SAMPLES, inference_steps=STEPS, batch_size=CB_BATCH, fixed_length=CB_FIXED)
    print(f"CB loop: 1a0q ({target.bucket}), score model ns={cfg.ns} lm {LM_DIM}, confidence model "
          f"ns={conf_model.cfg.ns} lmax={conf_model.cfg.sh_lmax}; {cb.inference_samples} samples x {cb.inference_steps} "
          f"steps a round, batch {cb.batch_size}, fixed_length {cb.fixed_length}, max_complexes_per_couple "
          f"{cb.max_complexes_per_couple}, lr {cb.lr}, EMA rollouts {cb.use_ema_for_rollouts}; cut: {cb.n_epochs} "
          f"epochs, cb_inference_freq 1, initial_iterations 1, inference_iterations 1, a one-complex cluster",
          flush=True)

    # the cutoff: the median confidence of a round drawn with the loop's first seed
    record = []
    t0 = time.perf_counter()
    finetune.inference_epoch(model, [target], torch.Generator(device=dev).manual_seed(CB_SEED), cfg,
                             dataclasses.replace(cb, confidence_cutoff=-1e9), cb_confidence_fn(conf_model, record),
                             device=dev)
    cutoff = float(np.median(record[0]["conf"].cpu().numpy()))
    cb = dataclasses.replace(cb, confidence_cutoff=cutoff)
    print(f"cutoff round (warm-up): {time.perf_counter() - t0:.3f} s; confidences "
          f"{np.round(np.sort(record[0]['conf'].cpu().numpy()), 4).tolist()}; cutoff (their median) {cutoff:.6f}",
          flush=True)

    marks.append(("cutoff round", time.perf_counter()))
    # the loop, instrumented: launches per round, confidence call and step;
    # the rollout model and the training state around each round; epoch 1's
    # rollout and one fine-tune step recorded for the replay
    rounds, conf_calls, steps, rolls = [], [], [], []
    recorded = {}
    real_epoch, real_weights, real_make_step = finetune.inference_epoch, finetune.rollout_weights, \
        train_loop.make_train_step

    def rollout_weights(roll, state, use_ema=True):
        out = real_weights(roll, state, use_ema)
        rolls.append(dict(model=roll, ema={n: e.clone() for n, e in state.ema.items()},
                          buffers={n: b.clone() for n, b in state.model.named_buffers()}, state=state))
        return out

    def inference_epoch(roll, targets, generator, model_cfg, cb_, confidence_fn=None, device=None, dp_mesh=None):
        state = rolls[-1]["state"]
        before, counts = snapshot(state), read_counters()
        calls = {}
        out = []
        run = lambda: out.append(real_epoch(roll, targets, generator, model_cfg, cb_, confidence_fn, device=device,
                                            dp_mesh=dp_mesh))
        if len(rounds) == CB_EPOCHS - 1:  # epoch 1's rollout: on the weights the fine-tune moved
            calls = record_calls(run)
        else:
            run()
        torch.cuda.synchronize()
        rounds.append(dict(launches=launch_diff(counts, read_counters()), untouched=same_snapshot(before, snapshot(state)),
                           metrics=dict(out[0][1]), confidences=conf_calls[-1]["conf"].cpu().numpy(), kept=out[0][0]))
        recorded["rollout"] = calls or recorded.get("rollout")
        return out[0]

    def make_train_step(model_cfg, tcfg, mesh=None):
        real = real_make_step(model_cfg, tcfg, mesh)

        def step(state, batch, generator, mark=None, grad_mask=None):
            counts = read_counters()
            out = []
            run = lambda: out.append(real(state, batch, generator, mark, grad_mask))
            if len(steps) == CB_EPOCHS * (CB_FIXED // CB_BATCH) - 1:  # the last step
                recorded["step"] = record_train_calls(run)
            else:
                run()
            torch.cuda.synchronize()
            steps.append(dict(launches=launch_diff(counts, read_counters())))
            return out[0]

        return step

    finetune.inference_epoch, finetune.rollout_weights, train_loop.make_train_step = \
        inference_epoch, rollout_weights, make_train_step
    try:
        for fn, attr in all_counters().values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        state, history = finetune.inference_finetune(model, [target], cfg, cb,
                                                     torch.Generator(device=dev).manual_seed(CB_SEED),
                                                     cb_confidence_fn(conf_model, conf_calls), workdir=CB_DIR,
                                                     device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        totals = read_counters()
    finally:
        finetune.inference_epoch, finetune.rollout_weights, train_loop.make_train_step = \
            real_epoch, real_weights, real_make_step

    marks.append(("loop", time.perf_counter()))
    # 1. every round: no failure, the cutoff applied, round 0 keeps and drops
    for r, h in zip(rounds, history):
        m = h["inference"]
        print(f"round {h['epoch']}: kept {m['n_kept']}/{m['n_sampled']}, rollout {m['wall_rollout']:.4f} s "
              f"({m['n_sampled'] / m['wall_rollout']:.3f} poses/s), RMSD {m['wall_rmsd']:.4f} s, confidence "
              f"{m['wall_confidence']:.4f} s; mean RMSD {m['mean_rmsd']:.3f} A, rmsds<2A {m['rmsds_lt2']:.3f}, mean "
              f"confidence {m['mean_confidence']:.4f}; failures {m['failures']}", flush=True)
        if m["failures"] != 0 or m["n_kept"] != int((r["confidences"] > cutoff).sum()) or m["n_sampled"] != CB_SAMPLES:
            fail(f"CB round {h['epoch']}: a failed target, or the cutoff not applied")
    if not 0 < history[0]["inference"]["n_kept"] < CB_SAMPLES:
        fail("CB round 0 must keep some poses and drop some")
    for h in history:
        n = len([s for s in steps]) // CB_EPOCHS
        print(f"epoch {h['epoch']}: {n} fine-tune steps, {h['wall_train']:.4f} s ({n * CB_BATCH / h['wall_train']:.3f} "
              f"training poses/s), loss {h['train']['loss']:.4f}; epoch wall {h['wall']:.4f} s; buffer "
              f"{h['buffer']['size']} complexes, mean confidence {h['buffer']['mean_confidence']:.4f}", flush=True)
    print(f"CB loop: {wall:.3f} s for {CB_EPOCHS} epochs ({len(rounds)} rounds, {len(steps)} fine-tune steps)",
          flush=True)

    # 2. launches per round, confidence call and fine-tune step, and in all
    zero = {k: 0 for k in totals}
    per_round = dict(zero, **{k: v for k, v in expected_launches(model, STEPS).items()},
                     **expected_conf_launches(conf_model))
    per_conf = dict(zero, **expected_conf_launches(conf_model))
    per_step = dict(zero, **expected_train_launches(model))
    print(f"launches per rollout round (its confidence call included): {rounds[0]['launches']}; per confidence call: "
          f"{conf_calls[0]['launches']}; per fine-tune step: {steps[0]['launches']}", flush=True)
    if (any(r["launches"] != per_round for r in rounds) or any(c["launches"] != per_conf for c in conf_calls)
            or any(s["launches"] != per_step for s in steps)):
        fail("the CB loop did not run a round, a confidence call or a fine-tune step through the kernels its "
             "config implies")
    want = {k: len(rounds) * per_round[k] + len(steps) * per_step[k] for k in zero}
    print(f"launches over the loop: {totals}; expected from the config: {want}", flush=True)
    if totals != want or any(want[k] and not totals[k] for k in want):
        fail("the CB loop's launch counts disagree with its config")

    # 3. the EMA rollout: epoch 1's rollout model against a fresh model with the EMA and the buffers
    if len(rolls) != CB_EPOCHS or not all(r["untouched"] for r in rounds):
        fail("a rollout changed the training model, its optimizer or its EMA")
    # the control: a model that runs epoch 1's weights through epoch 0's packs; both the output comparison and
    # the pack check must see it
    roll = rolls[-1]
    fresh = load_weights(get_model(cfg, device=dev, seed=1), roll["ema"], roll["buffers"])
    control = load_weights(get_model(cfg, device=dev, seed=1), rolls[0]["ema"], roll["buffers"])
    batch = replicate_complex(target.padded, 2, device=dev)
    batch = batch.replace(lig_pos=torch.as_tensor(near_crystal_poses(target.padded, 2), device=dev)).set_time(0.5, 0.5, 0.5)
    with torch.no_grad():
        control(batch)  # packs epoch 0's EMA
        keep_stale_packs(load_weights(control, roll["ema"], roll["buffers"]))
        got, ref, ctl = (out[:3] for out in (roll["model"](batch), fresh(batch), control(batch)))  # tr, rot, tor
    limit = [MODEL_RTOL * max(1.0, w.abs().max().item()) for w in ref]
    err = max((g - w).abs().max().item() / lim for g, w, lim in zip(got, ref, limit))
    ctl_err = max((c - w).abs().max().item() / lim for c, w, lim in zip(ctl, ref, limit))
    (stale, packs), (ctl_stale, ctl_packs) = stale_packs(roll["model"]), stale_packs(control)
    moved = max((roll["ema"][n] - rolls[0]["ema"][n]).abs().max().item() for n in roll["ema"] if roll["ema"][n].numel())
    print(f"EMA rollout model (epoch 1) against a fresh model with the EMA and the buffers: max_abs_err {err:.3g} of "
          f"the tolerance ({MODEL_RTOL} x max(1, max |fresh|)); its TP-conv packs against packs made now: {stale} of "
          f"{packs} stale. Control, epoch 1's weights through epoch 0's packs: {ctl_err:.3g} of the tolerance, "
          f"{ctl_stale} of {ctl_packs} packs stale. EMA moved {moved:.3g} since epoch 0", flush=True)
    if not (err <= 1.0 and packs > 0 and stale == 0 and ctl_err > 1.0 and ctl_stale > 0 and moved > 0):
        fail("the rollout model does not run the EMA weights the training produced, or the checks cannot see stale "
             "packs")
    del fresh, control

    marks.append(("checks 1-3", time.perf_counter()))
    # 4. epoch 1's rollout and the last fine-tune step, replayed on the moved weights
    calls = recorded["rollout"]
    counts = {name: len(calls[name]) for name in KERNELS}
    print(f"epoch 1 rollout replay: calls {counts}", flush=True)
    replay(calls, sample_kernels(), bitwise=("tpconv_rec", "tpconv_pb"), timed=False)
    calls = recorded["step"]
    check_tc_builds(calls, "CB fine-tune step")
    replay_train_kernels(calls, timed=False)
    replay_train_ops(calls, timed=False)
    del calls, recorded["rollout"], recorded["step"]
    torch.cuda.empty_cache()

    marks.append(("replays", time.perf_counter()))
    # 5. round 0 against the CPU: confidences, RMSDs, the kept set
    c0 = conf_calls[0]
    t0 = time.perf_counter()
    cpu_model = AllAtomScoreModel(conf_model.cfg, device="cpu", seed=0)
    b = replicate_complex(target.padded, CB_SAMPLES, device="cpu")
    lp = b.lig_pos.clone()
    lp[:, : c0["poses"].shape[1]] = c0["poses"].cpu()
    cpu_conf = score_confidence(cpu_model, b, lig_pos=lp).numpy()
    card_conf = c0["conf"].cpu().numpy()
    gt = rmsd.ground_truth_poses(target.hc)
    cpu_rmsd = rmsd.symmetry_rmsd(gt, c0["poses"].cpu().numpy(), mol.atomic_nums, mol.bonds)
    n0 = history[0]["inference"]["n_kept"]
    kept_rmsd = np.load(os.path.join(CB_DIR, "final_filtered_rmsds.npy"))[:n0]
    conf_err, peak = float(np.abs(card_conf - cpu_conf).max()), float(np.abs(cpu_conf).max())
    tol = MODEL_RTOL * max(1.0, peak)
    # the poses the loop kept, found by their coordinates among the round's
    host0 = c0["poses"].cpu().numpy()
    items = rounds[0]["kept"]
    kept_loop = np.array([sum(np.array_equal(it[0]["lig_pos"][: host0.shape[1]], pose) for it in items) == 1
                          for pose in host0])
    kept_cpu = cpu_conf > cutoff
    near = np.abs(cpu_conf - cutoff) <= tol
    rmsd_err = max(float(np.abs(kept_rmsd - cpu_rmsd[kept_loop]).max()) if n0 else 0.0,
                   abs(history[0]["inference"]["mean_rmsd"] - float(cpu_rmsd.mean())))
    print(f"round 0 on the CPU ({time.perf_counter() - t0:.1f} s): confidences max_abs_err {conf_err:.3g} (max |cpu| "
          f"{peak:.3g}, tolerance {MODEL_RTOL} x max(1, max |cpu|)); symmetry RMSDs max_abs_err {rmsd_err:.3g} A "
          f"(tolerance {RMSD_CPU_ATOL}); the loop kept {kept_loop.astype(int).tolist()}, the CPU keeps "
          f"{kept_cpu.astype(int).tolist()}: compared on {int((~near).sum())} of {len(host0)} poses ({int(near.sum())} "
          f"within the tolerance of the cutoff)", flush=True)
    if not (len(items) == n0 == int(kept_loop.sum()) and np.array_equal(kept_loop, card_conf > cutoff)
            and conf_err <= tol and rmsd_err <= RMSD_CPU_ATOL and np.array_equal(kept_loop[~near], kept_cpu[~near])):
        fail("CB round 0: the card disagrees with the CPU")
    del cpu_model

    marks.append(("round 0 on the CPU", time.perf_counter()))
    # 6. the workdir's weights and a train-state bundle back bit for bit
    for name, params in (("last_model", None), ("ema_model", state.ema)):
        loaded = checkpoints.load_params(os.path.join(CB_DIR, f"{name}.msgpack"), get_model(cfg, device=dev, seed=1))
        want_p = params or {n: p.detach() for n, p in state.model.named_parameters()}
        ok = (all(torch.equal(p, want_p[n]) for n, p in loaded.named_parameters())
              and all(torch.equal(b, state.model.get_buffer(n)) for n, b in loaded.named_buffers()))
        print(f"workdir {name}.msgpack ({os.path.getsize(os.path.join(CB_DIR, f'{name}.msgpack'))} bytes) back bit for "
              f"bit: {ok}", flush=True)
        if not ok:
            fail(f"the CB workdir's {name}.msgpack did not load back bit for bit")
    tcfg = finetune.finetune_config(cb)
    t0 = time.perf_counter()
    checkpoints.save_train_state(os.path.join(CB_DIR, "state"), state, epoch=CB_EPOCHS)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, epoch = checkpoints.load_train_state(os.path.join(CB_DIR, "state"),
                                                 train_loop.init_train_state(get_model(cfg, device=dev, seed=1), tcfg))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same = loaded is not None and epoch == CB_EPOCHS and same_snapshot(snapshot(state), snapshot(loaded))
    print(f"train-state bundle: {os.path.getsize(os.path.join(CB_DIR, 'state', 'last_state.msgpack'))} bytes, save "
          f"{t_save * 1e3:.1f} ms, load onto the card {t_load * 1e3:.1f} ms; parameters, buffers, EMA, Adam state, step "
          f"{state.step} and lr_scale {state.lr_scale} bit for bit: {same}", flush=True)
    if not same:
        fail("the train-state bundle did not load back bit for bit")
    # 7. the offline dataset: generated with the final EMA model, then read from its cache
    ema_model = finetune.rollout_weights(get_model(cfg, device=dev, seed=1).requires_grad_(False), state, True)
    args = dict(samples_per_target=CB_SAMPLES, inference_steps=STEPS, confidence_fn=cb_confidence_fn(conf_model),
                confidence_cutoff=cutoff, cache_path=os.path.join(CB_DIR, "offline"), device=dev)
    t0 = time.perf_counter()
    made = offline_dataset.generate_bootstrapping_complexes(ema_model, [target],
                                                            torch.Generator(device=dev).manual_seed(CB_SEED + 2), cfg,
                                                            **args)
    t_gen = time.perf_counter() - t0
    again = offline_dataset.generate_bootstrapping_complexes(None, [target], None, cfg, **args)
    equal = len(made) == len(again) and all(
        n == m and c == d and p.keys() == q.keys() and all(np.array_equal(p[k], q[k]) for k in p)
        for (p, n, c), (q, m, d) in zip(made, again))
    print(f"offline bootstrapping dataset: {len(made)} of {CB_SAMPLES} poses kept in {t_gen:.3f} s, read back from "
          f"its cache equal: {equal}", flush=True)
    if not equal:
        fail("the offline bootstrapping cache did not read back what was written")

    # 6, continued: one more step from the loaded state and from the original (same noise)
    step = train_loop.make_train_step(cfg, tcfg)
    sb = replicate_complex(target.padded, 4, device=dev)
    res = []
    for s in (state, loaded):
        m = step(s, sb, torch.Generator(device=dev).manual_seed(CB_SEED + 1))
        res.append((m["loss"].detach(), {n: p.detach() for n, p in s.model.named_parameters()},
                    dict(s.ema), dict(s.model.named_buffers())))
    (l0, p0, e0, b0), (l1, p1, e1, b1) = res
    checks = [("loss", l1, l0)] + [(f"param {n}", p1[n], p0[n]) for n in p0] + [(f"ema {n}", e1[n], e0[n]) for n in e0] \
        + [(f"stat {n}", b1[n], b0[n]) for n in b0]
    checks = [c for c in checks if c[2].numel()]  # irreps without scalars have empty batch-norm weights and statistics
    worst = max(((g - w).abs().max().item() / (MODEL_RTOL * max(1.0, w.abs().max().item())), n) for n, g, w in checks)
    print(f"one more step from the loaded state against the original's: loss {l1.item():.6f} vs {l0.item():.6f}; worst "
          f"error {worst[0]:.3g} of its tolerance ({MODEL_RTOL} x max(1, max |original|)) at {worst[1]}", flush=True)
    if not worst[0] <= 1.0:
        fail("a step from the loaded train state differs from the original's")

    marks.append(("files, bundle, offline cache", time.perf_counter()))
    # one more epoch of the loop under torch.profiler
    one = dataclasses.replace(cb, n_epochs=1)
    profile_run(lambda: finetune.inference_finetune(state.model, [target], cfg, one,
                                                    torch.Generator(device=dev).manual_seed(CB_SEED + 3),
                                                    cb_confidence_fn(conf_model), device=dev),
                history[-1]["wall"] * 1e3, host_ops=False)
    marks.append(("profiled epoch", time.perf_counter()))
    print("phase 11 walls: " + ", ".join(f"{name} {t - t_prev:.1f} s" for (_, t_prev), (name, t) in zip(marks, marks[1:]))
          + f"; in all {marks[-1][1] - marks[0][1]:.1f} s", flush=True)


# ---------------------------------------------------------------------------- phase 12: confidence training


CONF_B, CONF_LR, CONF_SAMPLES = 16, 3e-4, 4  # cli/confidence_train.py's defaults: batch, lr, samples a complex
CONF_CUTOFF, CONF_UPPER = 2.0, 4.0  # its RMSD cutoff, and the upper edge of the band left out of training
CONF_NEAR = 8  # near-crystal poses added to the cache (random weights roll out no pose within the cutoff)
# timed steps; the short train_confidence: its validation loss on 2 fixed batches, read on the running statistics,
# swings over the first epochs on seeded weights (five card runs from 0.761: epoch 2 at 1.84-2.93, epoch 4 at
# 0.157-0.193), so it runs 4 epochs; each epoch is also read on the batches' own statistics (``val_batch_stats``)
CONF_STEPS, CONF_EPOCHS, CONF_BATCHES, CONF_VAL = 5, 4, 8, 2
CONF_CPU_B = 2  # the card-against-CPU step's batch
CONF_SEED = 31
CONF_DIR = os.path.join(ROOT, "build", "confidence")  # the filtering cache; removed


def expected_conf_train_launches(model) -> dict:
    """Kernel launches of one confidence training step of the all-atom
    model (the JAX package's training routing): per receptor-embedding layer
    the residue and atom kNN groups on rec_g with the dropout mask and the
    two membership groups on the edge-list kernel; per ligand-embedding
    layer its pairs and bonds; per trunk layer the pairs, the bonds and the
    ligand <- residue and ligand <- atom lists on the edge-list kernel, and
    per trunk layer but the last the two kNN groups on rec_g with the mask
    and the four groups that scatter to residues and atoms on the edge-list
    kernel; one edge backward per op. No inference kernel runs."""
    P_rec, P_lig, C = len(model.rec_emb_layers), len(model.lig_emb_layers), len(model.conv_layers)
    edge = 2 * P_rec + 2 * P_lig + 4 * C + 4 * (C - 1)
    rec = 2 * P_rec + 2 * (C - 1)
    want = {name: 0 for name in all_counters()}
    want.update(tpconv_edge=edge, tpconv_rec_g_dm=rec, tpconv_bwd=edge + rec)
    return want


def bwd_builds(calls: dict) -> dict:
    """{call kind: {build: calls}}: the build of the edge backward each
    recorded call ran (``tpconv_bwd.bwd_on_tensor_cores``: ``tensor cores``
    or ``float32``), with its layer."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import sh_dim, tp_layout

    out = {}
    for (a, _), kind in zip(calls["tpconv_bwd"], calls["bwd_kind"]):
        ir_in, ir_sh, ir_out = a[9:12]
        lay = tp_layout(ir_in, ir_out, ir_sh)
        tc = tpconv_bwd.bwd_on_tensor_cores(a[0].shape[1], a[7].shape[0], lay.din, sh_dim(ir_sh), lay.dout, lay.n_x,
                                            len(lay.cg), len(tpconv_bwd.bwd_layout(ir_in, ir_out, ir_sh).vtab))
        key = f"{'tensor cores' if tc else 'float32'} ({lay.din} -> {lay.dout})"
        out.setdefault(kind, {}).setdefault(key, 0)
        out[kind][key] += 1
    return out


def float32_rec_g_dm(rec_calls: list) -> dict:
    """rec_g's training variant on its float32 build (``tpconv_rec_g_dm_kernel``,
    the build every lmax=2 call with the mask took before the tensor-core
    one) over the recorded calls: each against the plain version, timed as
    ``replay`` times it. -> {"ms": mean ms a call, "max_abs_err"}."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import TM

    pick = tpconv_g.rec_g_build
    tpconv_g.rec_g_build = lambda *a: (False, TM)
    ms, errs = [], []
    try:
        with torch.no_grad():
            for a, _ in rec_calls:
                run = lambda: tpconv_g.fused_tpconv_rec_g(*a[:14], dmask=a[14])
                got, want = run(), tpconv_g.tpconv_rec_g_plain(*a)
                torch.cuda.synchronize()
                errs.append((got - want).abs().max().item())
                if errs[-1] > KERNEL_RTOL * max(1.0, want.abs().max().item()):
                    fail("rec_g's float32 build with the mask disagrees with its plain version")
                ms.append(cuda_time(run, reps=5, warmup=1))
    finally:
        tpconv_g.rec_g_build = pick
    out = {"ms": float(np.mean(ms)), "max_abs_err": max(errs)}
    print(f"kernel tpconv_rec_g_dm on its float32 build (tpconv_rec_g_dm_kernel), the same {len(ms)} calls: "
          f"max_abs_err {out['max_abs_err']:.3g} ok; mean {out['ms']:.4f} ms", flush=True)
    return out


class FixedDraws:
    """A dataset that serves the same batches every time round: ``n``
    batches drawn once from ``dataset`` (the validation set of the short
    training run, so that every epoch is held to the same poses)."""

    def __init__(self, dataset, cache, n: int, batch_size: int):
        self.draws = [dataset.sample_batch(cache, batch_size) for _ in range(n)]
        self.i = 0

    def sample_batch(self, cache, batch_size: int):
        out = self.draws[self.i % len(self.draws)]
        self.i += 1
        return out


def conf_step_card_vs_cpu(dev, cfg, batch, labels) -> None:
    """One confidence training step's loss, every gradient and the batch
    statistics after it, the card against the CPU: the same seeded weights,
    the same batch, and the dropout masks drawn once on the card and moved
    to the CPU (``layers.dropout_mask`` recorded, then replayed). The
    gradients are held to phase 15's rule (``relu_excused``)."""
    import torch

    from confidence_bootstrapping_tpu_torch.confidence import train as ctrain
    from confidence_bootstrapping_tpu_torch.models import layers
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel

    draw = layers.dropout_mask
    masks = []

    def recorded(*a):
        m = draw(*a)
        masks.append(m.cpu())
        return m

    def replayed():
        it = iter(masks)
        return lambda shape, p, gen, d: next(it)

    def make_step(device, dtype=torch.float32):
        model = AllAtomScoreModel(cfg, device=device, seed=0).to(dtype)
        model.requires_grad_(True)
        b = batch.map(lambda t: t.to(device, dtype) if t.is_floating_point() else t.to(device))

        def step(mask_fn):
            layers.dropout_mask = mask_fn
            try:
                labels_d = ctrain._label_tensors(labels, device)
                bc = ctrain._maybe_compact(model, b)
                out = model(bc, deterministic=False, use_running_average=False,
                            generator=torch.Generator(device=device).manual_seed(CONF_SEED))
                loss = ctrain._losses(out, labels_d, bc.lig_mask, False, 1.0, 0.0, True)[0]
                names = [n for n, _ in model.named_parameters()]
                grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
            finally:
                layers.dropout_mask = draw
            return (loss.detach().cpu(), {n: (torch.zeros(()) if g is None else g.cpu()) for n, g in zip(names, grads)},
                    {n: b_.cpu() for n, b_ in model.named_buffers()})

        return model, step

    model, step = make_step(dev)
    (lg, gg, bg), at_relu = relu_units(model, lambda: step(recorded))
    lc, gc, bc_ = make_step(torch.device("cpu"))[1](replayed())
    worst, excused, reading = relu_excused(gg, gc, at_relu, lambda: make_step(torch.device("cpu"), torch.float64)[1](
        replayed())[1])
    for n, g, w in [("loss", lg, lc)] + [(f"stat {n}", bg[n], bc_[n]) for n in bc_ if bc_[n].numel()]:
        worst = max(worst, ((g - w).abs().max().item() / (MODEL_RTOL * max(1.0, w.abs().max().item())), n))
    print(f"confidence training step card vs CPU (B={batch.batch_size}, dropout {cfg.dropout}, {len(masks)} masks "
          f"drawn on the card): loss {lg.item():.6f} vs {lc.item():.6f}; {len(gc)} gradients and {len(bc_)} batch "
          f"statistics; worst error {worst[0]:.3g} of its tolerance ({MODEL_RTOL} x max(1, max |cpu|)) at {worst[1]}; "
          f"off it only at hidden units at the ReLU ({sum(map(len, at_relu.values()))} units on the card) where "
          f"float64 sides with one device: {len(excused)} rows (at most 4) {excused}; float64 reading {reading}",
          flush=True)
    if not (worst[0] <= 1.0 and len(excused) <= 4 and torch.isfinite(lg)):
        fail("confidence training step: the card disagrees with the CPU")


def conf_train_phase(dev, score_model, card: str) -> tuple:
    """Phase 12: confidence training (``confidence/``) at the pretrained
    confidence architecture's full width, phase 6's model with dropout 0.1:
    a filtering cache of 1a0q (its all-atom bucket) rolled out by phase 5's
    score model (4 samples x 20 steps, timed, back from its pickle bit for
    bit) with near-crystal poses added as positives; the CLI's batch (16,
    lr 3e-4, cutoff 2 A, the 2-4 A band left out, balanced); one warm-up and
    5 timed ``make_confidence_train_step`` calls (median, training poses/s,
    the split into crop + forward, backward and optimiser + EMA by CUDA
    events, the launches of every kernel per step against the config);
    every kernel call of one more step replayed through kernel and plain
    version (rec_g with the mask on its tensor-core build, the edge-list
    forward, the edge backward at lmax=2, and both autograd ops against
    plain autograd), one step under torch.profiler; one step card against
    CPU; the eval step leaving the batch statistics as they were; a short
    ``train_confidence`` whose validation loss must fall, its ROC-AUC
    printed. Every line printed carries ``card``. Returns (the replay's
    JSON rows, launches per step by kernel)."""
    import contextlib
    import shutil

    with contextlib.redirect_stdout(Tagged(sys.stdout, card)):
        shutil.rmtree(CONF_DIR, ignore_errors=True)
        try:
            return conf_train_run(dev, score_model)
        finally:
            shutil.rmtree(CONF_DIR, ignore_errors=True)


def val_batch_stats(model, draws) -> float:
    """The mean validation loss of ``draws`` ((batch, labels) pairs) at
    dropout 0 on each batch's own statistics (``use_running_average=False``)
    instead of the running ones the eval step reads; the running statistics
    are put back."""
    import torch

    from confidence_bootstrapping_tpu_torch.confidence import train as ctrain
    from confidence_bootstrapping_tpu_torch.train import train_loop

    saved = train_loop.batch_stats(model)
    losses = []
    with torch.no_grad():
        for b, labels in draws:
            bc = ctrain._maybe_compact(model, b)
            out = model(bc, deterministic=True, use_running_average=False)
            losses.append(ctrain._losses(out, ctrain._label_tensors(labels, b.lig_pos.device), bc.lig_mask, False, 1.0,
                                         0.0, False)[0].item())
    for n, buf in model.named_buffers():
        buf.copy_(saved[n])
    return float(np.mean(losses))


def conf_train_run(dev, score_model) -> tuple:
    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping.finetune import CBTarget
    from confidence_bootstrapping_tpu_torch.config import TrainConfig, confidence_model_config
    from confidence_bootstrapping_tpu_torch.confidence import dataset, train as ctrain
    from confidence_bootstrapping_tpu_torch.models.all_atom_model import AllAtomScoreModel
    from confidence_bootstrapping_tpu_torch.train import train_loop

    marks = [("start", time.perf_counter())]
    cfg = confidence_model_config(lm_embedding_dim=LM_DIM, dropout=0.1)
    tcfg = TrainConfig(batch_size=CONF_B, lr=CONF_LR)
    _, hc, mol = host_complex(LM_DIM, all_atoms=True)
    target = CBTarget(hc, mol, lm_dim=LM_DIM)
    L = len(hc.lig_f)

    # the filtering cache: phase 5's score model rolls out 1a0q, then the pickle is read back
    kw = dict(samples_per_complex=CONF_SAMPLES, inference_steps=STEPS, cache_path=CONF_DIR, cache_id="chip_smoke",
              device=dev)
    t0 = time.perf_counter()
    rollouts = dataset.generate_filtering_cache(score_model, [target], torch.Generator(device=dev).manual_seed(CONF_SEED),
                                                score_model.cfg, **kw)
    secs = time.perf_counter() - t0
    back = dataset.generate_filtering_cache(None, [target], None, None, **kw)
    same = back.keys() == rollouts.keys() and all(np.array_equal(back[k][i], rollouts[k][i]) and
                                                   back[k][i].dtype == rollouts[k][i].dtype
                                                   for k in rollouts for i in (0, 1))
    pos, rmsds = rollouts[target.name]
    print(f"phase 12 filtering cache: {CONF_SAMPLES} samples x {STEPS} steps of phase 5's score model on 1a0q "
          f"(N={target.bucket.N}, A={target.bucket.A}) in {secs:.3f} s; RMSDs {np.round(rmsds, 2).tolist()} A; "
          f"back from its pickle bit for bit: {same}", flush=True)
    if not (same and pos.shape == (CONF_SAMPLES, L, 3) and np.isfinite(pos).all()):
        fail("the filtering cache is not finite, or does not come back from its pickle bit for bit")
    crystal = dict(target.padded, lig_pos=target.padded["lig_pos"].copy())
    crystal["lig_pos"][:L] = hc.orig_lig_pos
    near = near_crystal_poses(crystal, CONF_NEAR).numpy()[:, :L]
    near_rmsd = np.sqrt(((near - hc.orig_lig_pos[None]) ** 2).sum(-1).mean(-1)).astype(np.float32)
    cache = dataset.combine_caches([rollouts, {target.name: (near, near_rmsd)}])
    ds = dataset.FilteringDataset([target], cache, CONF_CUTOFF, CONF_UPPER, balance=True, seed=0, device=dev)
    st = ds.statistics()
    print(f"filtering dataset: the rollouts and {CONF_NEAR} near-crystal poses (RMSDs {np.round(near_rmsd, 2).tolist()} "
          f"A); cutoff {CONF_CUTOFF} A, {CONF_CUTOFF}-{CONF_UPPER} A left out, balanced: {st}", flush=True)
    if not (st["positives"] and st["negatives"]):
        fail("the filtering dataset lacks a class")
    marks.append(("cache", time.perf_counter()))

    # timed steps at the CLI's batch
    model = AllAtomScoreModel(cfg, device=dev, seed=0)
    state = train_loop.init_train_state(model, tcfg)
    step = ctrain.make_confidence_train_step(model, tcfg)
    gen = torch.Generator(device=dev).manual_seed(CONF_SEED + 1)
    batches = [ds.sample_batch(cache, CONF_B) for _ in range(CONF_STEPS + 3)]
    print(f"confidence training: the pretrained confidence architecture (ns={cfg.ns}, nv={cfg.nv}, lmax={cfg.sh_lmax}, "
          f"{cfg.num_conv_layers} trunk layers, lm_dim {LM_DIM}, dropout {cfg.dropout}, crop {cfg.crop_beyond} A into "
          f"N={cfg.crop_res_cap} A={cfg.crop_atom_cap}), B={CONF_B}, lr {CONF_LR}, Adam, EMA {tcfg.ema_rate}; labels "
          f"of the steps' batches {[int(b[1]['y'].sum()) for b in batches]} positives of {CONF_B}", flush=True)
    t0 = time.perf_counter()
    step(state, *batches[0], gen)  # warm-up
    torch.cuda.synchronize()
    print(f"confidence training warm-up step: {time.perf_counter() - t0:.3f} s", flush=True)
    counters = all_counters()
    walls, parts, loss_vals, launches = [], [], [], []
    for batch, labels in batches[1: CONF_STEPS + 1]:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, batch, labels, gen, mark)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts.append((start.elapsed_time(events["forward"]), events["forward"].elapsed_time(events["backward"]),
                      events["backward"].elapsed_time(events["update"])))
        loss_vals.append(metrics["loss"].item())
        launches.append(read_counters())
    med = float(np.median(walls))
    fwd, bwd, upd = (float(np.median([p[i] for p in parts])) for i in range(3))
    print(f"confidence training step: median {med:.2f} ms over {CONF_STEPS} steps "
          f"({', '.join(f'{w:.1f}' for w in walls)}), {CONF_B / med * 1e3:.3f} training poses/s; CUDA events: crop + "
          f"forward {fwd:.2f} ms, backward {bwd:.2f} ms, optimiser + EMA {upd:.2f} ms; losses "
          f"{', '.join(f'{v:.4f}' for v in loss_vals)}", flush=True)
    want = expected_conf_train_launches(model)
    print(f"launches per confidence training step: {({k: v for k, v in launches[-1].items() if v})}; expected from the "
          f"config: {({k: v for k, v in want.items() if v})}, every other kernel 0", flush=True)
    if any(n != want for n in launches):
        fail("a confidence training step did not run every TP-conv through its kernels")
    if not all(np.isfinite(loss_vals)):
        fail("confidence training: a loss is not finite")
    marks.append(("steps", time.perf_counter()))

    # one step's kernel calls, replayed through kernel and plain version
    calls = record_train_calls(lambda: step(state, *batches[-2], gen))
    torch.cuda.synchronize()
    check_tc_builds(calls, "confidence training step")
    print(f"confidence training step: edge backward builds {bwd_builds(calls)}", flush=True)
    rows = replay_train_kernels(calls)
    rows += replay_train_ops(calls)
    f32 = float32_rec_g_dm(calls["tpconv_rec_g_dm"])
    for r in rows:
        if r["name"] == "tpconv_rec_g_dm":
            r["float32_build_ms"] = f32["ms"]
    per_step = dict(launches[-1], **{op: len(calls[op]) for op in TRAIN_OPS})
    del calls
    torch.cuda.empty_cache()
    marks.append(("replay", time.perf_counter()))
    profile_run(lambda: step(state, *batches[-1], gen), med)
    marks.append(("profile", time.perf_counter()))

    # the card against the CPU, and the eval step
    b2, l2 = ds.sample_batch(cache, CONF_CPU_B)
    conf_step_card_vs_cpu(dev, cfg, b2, l2)
    marks.append(("card vs CPU", time.perf_counter()))
    stats = train_loop.batch_stats(model)
    loss, conf, _ = ctrain.make_confidence_eval_step(model)(state, *batches[0])
    torch.cuda.synchronize()
    kept = all(torch.equal(b, stats[n]) for n, b in model.named_buffers())
    print(f"eval step: loss {loss.item():.4f}, confidences {conf.min().item():.4f} to {conf.max().item():.4f}; batch "
          f"statistics as they were: {kept}", flush=True)
    if not (kept and torch.isfinite(loss)):
        fail("the confidence eval step changed the batch statistics, or its loss is not finite")

    # a short training run: the validation loss must fall
    fresh = AllAtomScoreModel(cfg, device=dev, seed=0)
    val = FixedDraws(dataset.FilteringDataset([target], cache, CONF_CUTOFF, CONF_UPPER, balance=True, seed=CONF_SEED,
                                              device=dev), cache, CONF_VAL, CONF_B)
    evaluate = ctrain.make_confidence_eval_step(fresh)
    before = float(np.mean([evaluate(train_loop.TrainState(fresh, None, {}), b, l)[0].item() for b, l in val.draws]))
    own = [val_batch_stats(fresh, val.draws)]
    t0 = time.perf_counter()
    _, history = ctrain.train_confidence(fresh, ds, cache, tcfg, CONF_EPOCHS, CONF_BATCHES,
                                         torch.Generator(device=dev).manual_seed(CONF_SEED + 2), val_dataset=val,
                                         val_cache=cache,
                                         log=lambda line: own.append(val_batch_stats(fresh, val.draws)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = [h["val"]["loss"] for h in history]
    print(f"train_confidence: {CONF_EPOCHS} epochs x {CONF_BATCHES} batches in {secs:.2f} s (with the readings on the "
          f"batches' statistics); validation ({CONF_VAL} fixed batches) loss on the running statistics {before:.4f} "
          f"before, then {', '.join(f'{v:.4f}' for v in losses)}; on the batches' own statistics "
          f"{', '.join(f'{v:.4f}' for v in own)}; "
          f"accuracy {[round(h['val']['accuracy'], 4) for h in history]}; ROC-AUC (a measurement) "
          f"{[round(h['val']['roc_auc'], 4) for h in history]}; train loss "
          f"{[round(h['train']['loss'], 4) for h in history]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < before):
        fail("train_confidence: the validation loss did not fall")
    marks.append(("train_confidence", time.perf_counter()))
    print("phase 12 walls: " + ", ".join(f"{name} {t - t_prev:.1f} s" for (_, t_prev), (name, t) in zip(marks, marks[1:]))
          + f"; in all {marks[-1][1] - marks[0][1]:.1f} s", flush=True)
    for r in rows:  # launches per confidence training step
        print(f"phase 12 row: {json.dumps(dict(r, launches=per_step[r['name']]))}", flush=True)
    return [r for r in rows if r["name"] == "tpconv_rec_g_dm"], {"tpconv_rec_g_dm": per_step["tpconv_rec_g_dm"]}


# ---------------------------------------------------------------------------- phase 13: serve from files


SERVE_DIR = os.path.join(ROOT, "build", "serve_files")  # the inputs, model directories and outputs; removed
POS_ATOL = 1e-3  # featurized positions against the cache's: the PDB's 3 decimals and the SDF's 4, in A
SDF_ATOL = 1e-4  # a ranked SDF's coordinates (4 decimals) against the CLI's pose, in A
POCKET_B, SVGD_B, SVGD_STEPS, INFER_SAMPLES = 8, 4, 3, 8
# SVGD's weights, each log10 interpolated from _1 at the first step to _0 at the last
SVGD = dict(svgd_weight_log_0=-1.0, svgd_weight_log_1=0.0, svgd_repulsive_weight_log_0=0.0,
            svgd_repulsive_weight_log_1=1.0, svgd_kernel_size_log_0=0.0, svgd_kernel_size_log_1=0.5,
            svgd_langevin_weight_log_0=-1.0, svgd_langevin_weight_log_1=-0.5, svgd_rot_log_rel_weight=0.3,
            svgd_tor_log_rel_weight=-0.3)
# heavy-atom names a residue's seeded atoms take in the PDB, the C-alpha first (atom_type_3 names)
ATOM_NAMES = ("CA", "N", "C", "O", "CB", "CG", "CD", "CE", "NZ", "OG", "SD", "CG1", "CG2", "CD1", "CD2", "CE1", "CE2",
              "CZ", "OH", "NE", "NH1", "NH2", "OD1", "OD2", "OE1", "OE2", "ND1", "ND2", "NE1", "NE2", "CE3", "CZ2",
              "CZ3", "CH2", "OG1", "SG", "OXT")
SEEDED_SMILES = "CC(C)Cc1ccc(cc1)C(C)C(=O)NCc1ccc2OCOc2c1"  # the infer check's second complex: 26 heavy atoms


def write_pdb(path: str, residues) -> None:
    """ATOM records of ``residues``: (name, chain, number, [(atom name, element, xyz)])."""
    lines, serial = [], 1
    for resname, chain, seq, atoms in residues:
        for name, el, (x, y, z) in atoms:
            lines.append(f"ATOM  {serial:5d} {name:<4s} {resname:>3s} {chain}{seq:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00"
                         f"  0.00          {el:>2s}")
            serial += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")


def write_1a0q(d: str) -> tuple:
    """1a0q as files, from what the repository holds: the receptor as a PDB
    (a residue per cached node, named from ``rec_f``, its C-alpha at
    ``rec_pos + orig_center``; with it ``receptor_atoms``' seeded atoms, the
    first of each residue's at its C-alpha, so the all-atom graph keeps 3183
    atoms), the cache's ligand as an SDF with the explicit hydrogens its
    features count (H counts in ``lig_f`` column 5, no implicit ones in
    column 4: the original file carried them), seeded per-chain ESM
    embeddings as a ``.pt`` dict. -> (protein, ligand, embeddings paths,
    the atoms' positions [A, 3] and residues [A] as written)."""
    import torch

    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_cache
    from confidence_bootstrapping_tpu_torch.data.mol_io import Molecule, write_sdf
    from confidence_bootstrapping_tpu_torch.data.vocab import AMINO_ACIDS

    os.makedirs(d, exist_ok=True)
    hc, mol = load_host_cache(CACHE_PKL)
    atoms = receptor_atoms(hc.rec_f, hc.rec_pos, N_ATOMS)
    atom_pos = atoms["atom_pos"].astype(np.float64) + hc.orig_center
    residues = []
    for i, f in enumerate(hc.rec_f):
        idx = np.nonzero(atoms["atom_res"] == i)[0]
        if len(idx) > len(ATOM_NAMES):
            fail(f"residue {i} has {len(idx)} seeded atoms, over the {len(ATOM_NAMES)} names")
        atom_pos[idx[0]] = hc.rec_pos[i] + hc.orig_center
        residues.append((AMINO_ACIDS[f] if f < len(AMINO_ACIDS) else "UNK", "A", i + 1,
                         [(n, n[0], atom_pos[j]) for n, j in zip(ATOM_NAMES, idx)]))
    prot = os.path.join(d, "1a0q_protein_processed.pdb")
    write_pdb(prot, residues)

    rng = np.random.RandomState(3)
    n_h = hc.lig_f[:, 5] - hc.lig_f[:, 4]
    h_of = np.repeat(np.arange(mol.num_atoms), n_h)
    u = rng.randn(len(h_of), 3)
    pos = np.concatenate([mol.pos, mol.pos[h_of] + u / np.linalg.norm(u, axis=1, keepdims=True)])
    bonds = list(mol.bonds) + [(int(a), mol.num_atoms + k, 1) for k, a in enumerate(h_of)]
    with_h = Molecule(np.concatenate([mol.atomic_nums, np.ones(len(h_of), int)]), pos, bonds,
                      np.zeros(len(pos), int), "1a0q_ligand")
    lig = os.path.join(d, "1a0q_ligand.sdf")
    write_sdf(with_h, pos, lig)
    esm = os.path.join(d, "1a0q_esm.pt")
    torch.save({"A": torch.as_tensor(np.random.RandomState(1).randn(len(hc.rec_f), LM_DIM).astype(np.float32))}, esm)
    # the written (rounded) coordinates, as the featurization reads them
    return prot, lig, esm, np.round(atom_pos, 3), atoms["atom_res"]


def write_seeded_complex(d: str, n_res: int = 200, seed: int = 4) -> np.ndarray:
    """A seeded second complex in other buckets (L=32, N=256): a receptor
    of n_res residues (N, CA, C, O each) spread around the origin and the
    ligand SEEDED_SMILES embedded and placed at its first residue. -> its
    per-residue ESM embeddings [n_res, LM_DIM]."""
    from confidence_bootstrapping_tpu_torch.data.conformers import mol_from_smiles
    from confidence_bootstrapping_tpu_torch.data.mol_io import write_sdf
    from confidence_bootstrapping_tpu_torch.data.vocab import AMINO_ACIDS

    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    ca = rng.randn(n_res, 3) * 9.0
    off = {"N": [1.2, 0.8, 0.0], "C": [-1.2, 0.8, 0.0], "O": [-1.6, 2.0, 0.3]}
    residues = [(AMINO_ACIDS[rng.randint(20)], "A", i + 1, [("CA", "C", ca[i])] + [
        (n, n[0], ca[i] + np.asarray(o)) for n, o in off.items()]) for i in range(n_res)]
    write_pdb(os.path.join(d, "seeded_protein_processed.pdb"), residues)
    mol = mol_from_smiles(SEEDED_SMILES, seed=seed)
    pos = mol.pos - mol.pos.mean(0) + ca[0] + 4.0
    write_sdf(mol, pos, os.path.join(d, "seeded_ligand.sdf"), name="seeded")
    return rng.randn(n_res, LM_DIM).astype(np.float32)


def featurization_check(d, prot_atoms: np.ndarray, prot_atom_res: np.ndarray) -> None:
    """Check 1: the complex the dock CLI featurized from the files against the
    committed cache: ligand features, edges, torsions, mask_rotate and rec_f
    exact; the crystal pose and the C-alphas within POS_ATOL; each residue's
    kNN list the same set, where not, named with the margin that lets the
    files' rounding swap it; the receptor atoms as written."""
    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_cache

    want, _ = load_host_cache(CACHE_PKL)
    hc = d.hc
    exact = {k: bool(np.array_equal(getattr(hc, k), getattr(want, k)))
             for k in ("lig_f", "lig_edge_src", "lig_edge_dst", "lig_edge_attr", "tor_src", "tor_dst", "mask_rotate",
                       "rec_f")}
    lig_err = float(np.abs((hc.orig_lig_pos + hc.orig_center) - (want.orig_lig_pos + want.orig_center)).max())
    rec_err = float(np.abs((hc.rec_pos + hc.orig_center) - (want.rec_pos + want.orig_center)).max())
    atom_err = float(np.abs(hc.atom_pos + hc.orig_center - prot_atoms).max()) if len(hc.atom_pos) == N_ATOMS else np.inf
    differ, unexplained = [], []
    rp = want.rec_pos.astype(np.float64)
    for i in range(len(hc.rec_f)):
        a, b = set(hc.rec_nbr[i].tolist()), set(want.rec_nbr[i].tolist())
        if a == b:
            continue
        d_all = np.linalg.norm(rp - rp[i], axis=1)
        gap = abs(max(d_all[list(b - a)]) - min(d_all[list(a - b)]))  # the swapped pair's distances from residue i
        differ.append(f"residue {i}: {sorted(a - b)} in for {sorted(b - a)} (distances {gap:.2g} A apart)")
        if gap > 2 * POS_ATOL:
            unexplained.append(i)
    print(f"featurized from the files ({d.featurize_s:.3f} s): exact {exact}; crystal ligand max_abs_err {lig_err:.3g} A, "
          f"C-alphas {rec_err:.3g} A, {len(hc.atom_pos)} receptor atoms {atom_err:.3g} A (tolerance {POS_ATOL} A); "
          f"kNN lists differing from the cache's: {len(differ)} of {len(hc.rec_f)}", flush=True)
    for line in differ:
        print(f"  {line}: within the files' rounding" if int(line.split(":")[0].split()[1]) not in unexplained
              else f"  {line}: NOT within the files' rounding")
    if not (all(exact.values()) and max(lig_err, rec_err, atom_err) <= POS_ATOL and not unexplained
            and np.array_equal(hc.atom_res, prot_atom_res)):
        fail("the complex featurized from the files differs from the cache's")


def ranked_sdf_check(out: str, pos: np.ndarray, conf: np.ndarray, center: np.ndarray) -> None:
    """Check 2: one ranked SDF per pose, each parsing back to the CLI's pose
    within SDF_ATOL, the ranks falling with the confidences."""
    from confidence_bootstrapping_tpu_torch.data.mol_io import parse_sdf

    files = sorted((f for f in os.listdir(out) if f.startswith("rank")), key=lambda f: int(f[4:].split("_")[0]))
    order = np.argsort(-np.nan_to_num(conf, nan=-1e9))
    errs = [float(np.abs(parse_sdf(os.path.join(out, f)).pos - center - pos[i]).max()) for f, i in zip(files, order)]
    in_names = [float(f.split("_confidence")[1][:-4]) for f in files]
    falling = all(a >= b for a, b in zip(conf[order], conf[order][1:])) and in_names == sorted(in_names, reverse=True)
    print(f"ranked SDFs: {len(files)} written, coordinates max_abs_err {max(errs):.3g} A (tolerance {SDF_ATOL} A); "
          f"confidences falling with rank: {falling} ({in_names[0]} to {in_names[-1]})", flush=True)
    if len(files) != len(pos) or max(errs) > SDF_ATOL or not falling:
        fail("the ranked SDFs do not hold the CLI's poses in confidence order")


def cli_numbers(text: str) -> dict:
    """The featurization seconds, poses/s and rerank ms the dock CLI printed."""
    import re

    return dict(featurize_s=float(re.search(r"featurization ([0-9.]+)s", text).group(1)),
                poses_s=float(re.search(r"\(([0-9.]+) poses/s\)", text).group(1)),
                rerank_ms=float(re.search(r"reranked \d+ poses in ([0-9.]+) ms", text).group(1)))


def serve_files_phase(dev, score_model, conf_model, card: str, phase5_poses_s: float) -> None:
    """Phase 13: dock and infer from PDB and SDF files through the CLIs
    (``cli/dock.main``, ``cli/infer.main``) at full width: phase 5's score
    model and phase 6's confidence model as model directories, 1a0q written
    to files from the cache (``write_1a0q``). Checks: the featurized
    complex against the cache; the ranked SDFs; the kernel launches of the
    CLI's sample and rerank against the config; every kernel call of them
    replayed through kernel and plain version; the CLI's poses against a
    direct ``sample`` on the same padded batch and generator. Then a
    pocket-knowledge dock, a 3-step SVGD sample card against CPU, and an
    evaluator run over 1a0q and a seeded complex (``write_seeded_complex``).
    Every line printed carries ``card``."""
    import contextlib
    import shutil

    with contextlib.redirect_stdout(Tagged(sys.stdout, card)):
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
        try:
            serve_files_run(dev, score_model, conf_model, phase5_poses_s)
        finally:
            shutil.rmtree(SERVE_DIR, ignore_errors=True)


def serve_files_run(dev, score_model, conf_model, phase5_poses_s: float) -> None:
    import contextlib
    import io
    import shutil

    import torch

    from confidence_bootstrapping_tpu_torch.cli import dock, infer
    from confidence_bootstrapping_tpu_torch.config import SamplerConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_cache, replicate_complex
    from confidence_bootstrapping_tpu_torch.data.featurize import pocket_center
    from confidence_bootstrapping_tpu_torch.eval.rmsd import ground_truth_poses, symmetry_rmsd
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g
    from confidence_bootstrapping_tpu_torch.sampler import sampling
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    t_phase = time.perf_counter()
    inputs = os.path.join(SERVE_DIR, "inputs")
    prot, lig, esm, prot_atoms, prot_atom_res = write_1a0q(inputs)
    dirs = {}
    for name, m in (("score", score_model), ("confidence", conf_model)):
        dirs[name] = os.path.join(SERVE_DIR, name)
        checkpoints.save_model_dir(dirs[name], m.cfg, m)
    device_arg = ["--device", "cpu"] if dev.type == "cpu" else []  # the card is the CLI's default
    argv = ["--protein_path", prot, "--ligand", lig, "--samples", str(B_POSES), "--batch_size", str(B_POSES),
            "--inference_steps", str(STEPS), "--model_dir", dirs["score"], "--confidence_model_dir",
            dirs["confidence"], "--esm_embeddings_path", esm, "--out_dir", os.path.join(SERVE_DIR, "dock"),
            "--seed", "0"] + device_arg
    out = os.path.join(SERVE_DIR, "dock", "1a0q_ligand")

    d = dock.prepare(dock.get_parser().parse_args(argv), dev)
    featurization_check(d, prot_atoms, prot_atom_res)

    # the dock call: counted, every kernel call recorded; its printout kept for its numbers
    counters = dict(score_counters(), tpconv_rec_g=tpconv_g.fused_tpconv_rec_g,
                    tpconv_cross_g=tpconv_g.fused_tpconv_cross_g)
    for fn in counters.values():
        fn.launches = 0
    result, text = {}, io.StringIO()
    with contextlib.redirect_stdout(text):
        calls = record_calls(lambda: result.update(r=dock.main(argv)), KERNELS + CONF_KERNELS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(text.getvalue().rstrip(), flush=True)
    pos, conf = result["r"]
    L = len(d.hc.lig_f)
    if pos.shape != (B_POSES, L, 3) or not np.isfinite(pos).all() or not np.isfinite(conf).all():
        fail("the dock CLI's poses or confidences are not finite, or not of the expected shape")
    ranked_sdf_check(out, pos, conf, d.hc.orig_center)
    want = dict(expected_launches(d.model, STEPS), **expected_conf_launches(d.conf_model))
    print(f"dock CLI launches: {launches}; expected from the config (one sample of {B_POSES} poses x {STEPS} steps "
          f"and one rerank): {want}", flush=True)
    if launches != want:
        fail("the dock CLI did not run every TP-conv of its sample and rerank through its kernel")
    check_tc_builds({"tpconv_cross_g": calls["tpconv_cross_g"]}, "dock CLI rerank")
    kernels = dict(sample_kernels(), tpconv_rec_g=(tpconv_g.fused_tpconv_rec_g, tpconv_g.tpconv_rec_g_plain, rec_work,
                                                   "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:457"),
                   tpconv_cross_g=(tpconv_g.fused_tpconv_cross_g, tpconv_g.tpconv_cross_g_plain, cross_g_work,
                                   "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:547"))
    replay(calls, kernels, bitwise=("tpconv_rec", "tpconv_pb", "tpconv_rec_g", "tpconv_cross_g"), timed=False)
    del calls

    # the CLI's poses against a direct sample on the same padded batch, with the same generator
    def direct():
        gen = torch.Generator(device=dev).manual_seed(0)
        b0 = sampling.randomize_position(replicate_complex(d.padded, B_POSES, device=dev), gen,
                                         d.cfg.sigma.tr_sigma_max)
        return b0, sampling.sample(d.model, b0, d.cfg, d.sampler_cfg, gen, device=dev)[0].lig_pos[:, :L].cpu().numpy()

    b0, final = direct()
    pos_tol = rerun_tolerance(lambda: direct()[1], final, SAMPLE_ATOL, "the direct sample")
    err = float(np.abs(final - pos).max())
    print(f"dock CLI poses against a direct sample (plan {d.sampler_cfg.rec_phase_steps}:"
          f"{d.sampler_cfg.rec_phase_caps}): max_abs_err {err:.3g} A (tolerance {pos_tol:.3g} A)", flush=True)
    if not err <= pos_tol:
        fail("the dock CLI's poses differ from a direct sample of the same batch and generator")

    # timed, then under the profiler
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        dock.main(argv)
    torch.cuda.synchronize()
    dock_s = time.perf_counter() - t0
    nums = cli_numbers(text.getvalue())
    with contextlib.redirect_stdout(io.StringIO()):
        idle = profile_run(lambda: dock.main(argv), dock_s * 1e3)
    print(f"dock CLI, {B_POSES} poses x {STEPS} steps with the rerank: wall {dock_s:.3f} s (featurization "
          f"{nums['featurize_s']:.3f} s, sample {nums['poses_s']:.3f} poses/s against phase 5's "
          f"{phase5_poses_s:.3f} in this call, rerank {nums['rerank_ms']:.1f} ms); card idle "
          f"{'not measured' if idle is None else f'{idle:.3f}'} of the call", flush=True)

    # pocket knowledge: the poses start at the pocket center
    pk_argv = argv[:argv.index("--confidence_model_dir")] + argv[argv.index("--esm_embeddings_path"):]
    pk_argv[pk_argv.index("--samples") + 1] = pk_argv[pk_argv.index("--batch_size") + 1] = str(POCKET_B)
    pk_argv[pk_argv.index("--out_dir") + 1] = os.path.join(SERVE_DIR, "pocket")
    with contextlib.redirect_stdout(io.StringIO()):
        pk_pos, _ = dock.main(pk_argv + ["--pocket_knowledge"])
    center = pocket_center(d.hc)
    start = sampling.randomize_position(replicate_complex(d.padded, POCKET_B, device=dev),
                                        torch.Generator(device=dev).manual_seed(0), d.cfg.sigma.tr_sigma_max,
                                        no_random=True,
                                        pocket_center=torch.as_tensor(np.tile(center, (POCKET_B, 1)), device=dev))
    c_err = float(np.abs(start.lig_pos[:, :L].mean(1).cpu().numpy() - center).max())
    n_files = len(os.listdir(os.path.join(SERVE_DIR, "pocket", "1a0q_ligand")))
    print(f"pocket knowledge: {POCKET_B} poses docked ({n_files} SDFs), final centroids "
          f"{np.linalg.norm(pk_pos.mean(1) - center, axis=1).max():.3g} A at most from the pocket center; the prior "
          f"without noise centred on it within {c_err:.3g} A", flush=True)
    if n_files != POCKET_B or not np.isfinite(pk_pos).all() or not c_err <= 1e-4:
        fail("the pocket-knowledge dock failed")

    # SVGD: 3 steps at B=4, the card against the CPU with the same injected noise
    scfg = SamplerConfig(inference_steps=SVGD_STEPS, **SVGD)
    R = d.padded["tor_src"].shape[0]
    rng = np.random.RandomState(6)
    zs = [[rng.randn(*s).astype(np.float32) for s in ((SVGD_B, 3), (SVGD_B, 3), (SVGD_B, R))]
          for _ in range(SVGD_STEPS)]
    start = b0.lig_pos[:SVGD_B].cpu()
    ends = []
    cpu_model = get_model(d.cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in d.model.state_dict().items()})
    for device, model, svgd in ((dev, d.model, True), (torch.device("cpu"), cpu_model, True), (dev, d.model, False)):
        c = scfg if svgd else SamplerConfig(inference_steps=SVGD_STEPS)
        batch = replicate_complex(d.padded, SVGD_B, device=device).replace(lig_pos=start.to(device))
        cache = sampling.receptor_cache(model, batch)
        sched = sampling.make_schedules(c)
        for i, (tr_z, rot_z, tor_z) in enumerate(zs):
            t = lambda a: torch.as_tensor(a, device=device)
            batch = sampling.reverse_diffusion_step(model, batch, cache, i, sched, d.cfg, c, tr_z=t(tr_z),
                                                    rot_z=t(rot_z), tor_z=t(tor_z))
        ends.append(batch.lig_pos.cpu())
    err, moved = (ends[0] - ends[1]).abs().max().item(), (ends[0] - ends[2]).abs().max().item()
    print(f"SVGD {SVGD_STEPS}-step sample at B={SVGD_B}: card against CPU max_abs_err {err:.3g} A (tolerance "
          f"{SAMPLE_ATOL} A); SVGD moves the poses {moved:.3g} A from the plain sample's", flush=True)
    if not (err <= SAMPLE_ATOL and moved > 0.1):
        fail("the SVGD sample on the card disagrees with the CPU, or SVGD changes nothing")

    # the evaluator over 1a0q and a seeded complex
    data = os.path.join(SERVE_DIR, "data")
    os.makedirs(os.path.join(data, "1a0q"))
    for src in (prot, lig):
        shutil.copy(src, os.path.join(data, "1a0q", os.path.basename(src)))
    seeded_lm = write_seeded_complex(os.path.join(data, "seeded"))
    embs = {"1a0q": torch.load(esm)["A"].numpy(), "seeded": seeded_lm}
    torch.save(embs, os.path.join(SERVE_DIR, "infer_esm.pt"))
    ev = os.path.join(SERVE_DIR, "eval")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        m = infer.main(["--data_dir", data, "--samples_per_complex", str(INFER_SAMPLES), "--inference_steps",
                        str(STEPS), "--model_dir", dirs["score"], "--confidence_model_dir", dirs["confidence"],
                        "--esm_embeddings_path", os.path.join(SERVE_DIR, "infer_esm.pt"), "--save_complexes",
                        "--cache_path", os.path.join(SERVE_DIR, "cache"), "--out_dir", ev] + device_arg)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 2 * n for name, n in want.items()}  # a sample and a rerank per complex (one batch of 8 poses)
    rmsds, names = np.load(os.path.join(ev, "rmsds.npy")), list(np.load(os.path.join(ev, "complex_names.npy")))
    rmsd_err = 0.0
    for row, name in zip(rmsds, names):
        cached = [f for f in os.listdir(os.path.join(SERVE_DIR, "cache")) if f.startswith(f"infer_{name}_")]
        hc, heavy = load_host_cache(os.path.join(SERVE_DIR, "cache", cached[0]))
        poses = np.load(os.path.join(ev, "poses", f"{name}.npy"))
        again = symmetry_rmsd(ground_truth_poses(hc), poses, heavy.atomic_nums, heavy.bonds)
        rmsd_err = max(rmsd_err, float(np.abs(again - row).max()))
    print(f"infer over {[str(n) for n in names]}: {infer_s:.3f} s, n_complexes {m['n_complexes']}, failures {m['failures']}, "
          f"{m['poses_per_sec']} poses/s, mean RMSD {m['mean_rmsd']} A (random weights); RMSDs against eval/rmsd on "
          f"the saved poses max_abs_err {rmsd_err:.3g} A (tolerance {RMSD_ATOL} A); launches {launches}, expected from "
          f"the config {want}", flush=True)
    if m["n_complexes"] != 2 or m["failures"] != 0 or not rmsd_err <= RMSD_ATOL or launches != want:
        fail("the evaluator over the files failed")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------- phase 14: the training CLIs from files


TRAIN_DIR = os.path.join(ROOT, "build", "train_files")  # inputs, model directories, caches and workdirs; removed
TRAIN_B, TRAIN_EPOCHS, BENCH_SAMPLES = 16, 2, 8  # cli.train: --batch_size, --n_epochs, --inference_samples
TORS_B, TORS_EPOCHS, TORS_CPU_B = 16, 2, 2  # the torsional CLI's batch and epochs; the card-against-CPU step's batch
GEN_SAMPLES, FT_FIXED = 8, 32  # bootstrap_gen's and finetune's samples a target; finetune's --fixed_length
CT_SAMPLES, CT_BATCHES, CT_TEST_SAMPLES, CT_NS, CT_NV = 4, 4, 2, 24, 6  # confidence_train's cache, batches, --test, width
TRAIN_OVERLAY = None  # a --config overlay for every score model of the phase (None: the CLI's default, full width)
# the torsional set: 16 molecules of 5-19 heavy atoms, each with a rotatable bond, from 2 seeds at 2 orientations each
MOL_SMILES = ("CCCCO", "CC(C)Cc1ccccc1", "OCCN(C)CC", "CCOC(=O)CCN", "c1ccccc1CCc1ccccc1", "CC(=O)Nc1ccc(O)cc1",
              "CCN(CC)CCOC(=O)c1ccc(N)cc1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "COc1ccccc1CN", "CCCC(=O)OC",
              "NCCc1ccc(O)c(O)c1", "CC(C)NCC(O)COc1cccc2ccccc12", "OC(=O)CCc1ccccc1", "CCSCC(N)C(=O)O",
              "CC(C)(C)OC(=O)NCC", "Cc1ccc(S(=O)(=O)NC)cc1")
MOL_SEEDS, MOL_TURNS = 2, 2


def write_molecules(d: str) -> int:
    """The torsional set as SDFs: each of MOL_SMILES embedded from MOL_SEEDS
    seeds (``mol_from_smiles``), each conformer written at MOL_TURNS seeded
    orientations. -> the number of files."""
    from scipy.spatial.transform import Rotation

    from confidence_bootstrapping_tpu_torch.data.conformers import mol_from_smiles
    from confidence_bootstrapping_tpu_torch.data.mol_io import write_sdf

    os.makedirs(d, exist_ok=True)
    rng, n = np.random.RandomState(9), 0
    for smi in MOL_SMILES:
        for seed in range(MOL_SEEDS):
            mol = mol_from_smiles(smi, seed=seed)
            for _ in range(MOL_TURNS):
                rot = Rotation.random(random_state=rng).as_matrix()
                write_sdf(mol, (mol.pos - mol.pos.mean(0)) @ rot.T, os.path.join(d, f"mol{n:03d}.sdf"), name=f"mol{n:03d}")
                n += 1
    return n


def nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def expected_torsional_launches(model) -> dict:
    """Kernel launches of one torsional training step: per ligand-embedding
    layer the pairs (K-sum) and the bonds (per edge), and the torsion conv
    (per edge), on the edge-list kernel; one edge backward per op."""
    edge = 2 * len(model.lig_emb_layers) + 1
    return {"tpconv_edge": edge, "tpconv_bwd": edge}


def counted_calls(module, name: str, record: list, factory: bool = True):
    """A context that wraps ``module.<name>``: a function that makes a step
    (``make_train_step``, ...), or without ``factory`` a call to count
    itself (a rollout round): each step's or call's launches of every kernel
    (``read_counters``, the nonzero ones) and wall, synchronised, are
    appended to ``record``."""
    import contextlib

    import torch

    orig = getattr(module, name)

    def counted(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            before, t0 = read_counters(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            record.append(dict(wall=time.perf_counter() - t0, launches=nonzero(launch_diff(before, read_counters()))))
            return out
        return call

    wrapper = (lambda *a, **kw: counted(orig(*a, **kw))) if factory else counted(orig)

    @contextlib.contextmanager
    def ctx():
        setattr(module, name, wrapper)
        try:
            yield record
        finally:
            setattr(module, name, orig)

    return ctx()


def recorded_saves(saved: dict):
    """A context in which ``train.checkpoints.save_params`` also keeps, per
    path, the Flax variables it writes (numpy copies: the last write wins)."""
    import contextlib

    from confidence_bootstrapping_tpu_torch.models.from_flax import flax_from_state_dict
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    orig = checkpoints.save_params

    def save(path, model, params=None):
        saved[path] = flax_from_state_dict(model, params)
        return orig(path, model, params)

    @contextlib.contextmanager
    def ctx():
        checkpoints.save_params = save
        try:
            yield saved
        finally:
            checkpoints.save_params = orig

    return ctx()


def files_back(saved: dict) -> list:
    """The msgpack files ``recorded_saves`` kept whose bytes do not restore
    to what was written, leaf for leaf (none: every file back bit for bit)."""
    from confidence_bootstrapping_tpu_torch.train import flax_msgpack

    def leaves(t, p=()):
        return [x for k in sorted(t) for x in leaves(t[k], p + (k,))] if isinstance(t, dict) else [(p, t)]

    bad = []
    for path, tree in saved.items():
        with open(path, "rb") as f:
            back = flax_msgpack.restore(f.read())
        a, b = leaves(back), leaves(tree)
        if [p for p, _ in a] != [p for p, _ in b] or not all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b)):
            bad.append(os.path.basename(path))
    return bad


def weights_back(path: str, model, params: dict = None) -> bool:
    """``path`` loads into a fresh model of ``model``'s config (strict) with
    ``params`` (default: the model's own) and its buffers, bit for bit."""
    import torch

    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    dev = next(model.parameters()).device
    loaded = checkpoints.load_params(path, get_model(model.cfg, device=dev, seed=1))
    want = params or {n: p.detach() for n, p in model.named_parameters()}
    return (all(torch.equal(p, want[n]) for n, p in loaded.named_parameters())
            and all(torch.equal(b, model.get_buffer(n)) for n, b in loaded.named_buffers()))


def steps_line(what: str, steps: list, batch: int, want: dict, unit: str = "training poses/s") -> None:
    """Prints a CLI's steps (count, walls; the median and the rate over the
    steps after the first, which in a process's first call also builds the
    so3/torus tables and the weight packs) and fails unless every step's
    launches are ``want``'s."""
    walls = [s["wall"] for s in steps]
    warm = walls[1:] or walls
    med = float(np.median(warm)) if warm else float("nan")
    rate = batch * len(warm) / sum(warm) if warm else float("nan")
    print(f"{what}: {len(steps)} steps, walls {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; after the first, "
          f"median {med * 1e3:.1f} ms, {rate:.3f} {unit}; launches per step {steps[-1]['launches'] if steps else None}, "
          f"expected from the config {nonzero(want)}", flush=True)
    if not steps or any(s["launches"] != nonzero(want) for s in steps):
        fail(f"{what}: a step did not run every TP-conv through its kernels")


def train_files_phase(dev, card: str) -> None:
    """Phase 14: the training CLIs from files at full width (``cli.train``
    in both modes, ``cli.bootstrap_gen``, ``cli.finetune``,
    ``cli.confidence_train``; see the module docstring). Every line printed
    carries ``card``."""
    import contextlib
    import shutil

    with contextlib.redirect_stdout(Tagged(sys.stdout, card)):
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        try:
            train_files_run(dev)
        finally:
            shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def train_files_run(dev) -> None:
    import contextlib
    import dataclasses
    import io
    import pickle

    import torch

    from confidence_bootstrapping_tpu_torch.bootstrapping import finetune as ft
    from confidence_bootstrapping_tpu_torch.bootstrapping.offline_dataset import generate_bootstrapping_complexes
    from confidence_bootstrapping_tpu_torch.cli import bootstrap_gen, confidence_train, finetune, train as train_cli
    from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
    from confidence_bootstrapping_tpu_torch.config import (ScoreModelConfig, TrainConfig, confidence_model_config,
                                                           load_score_config)
    from confidence_bootstrapping_tpu_torch.confidence import train as ctrain
    from confidence_bootstrapping_tpu_torch.data import torsional
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex, pick_bucket, replicate_complex
    from confidence_bootstrapping_tpu_torch.data.dataset import ComplexDataset, discover_dir
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.train import checkpoints, train_loop

    marks = [("start", time.perf_counter())]
    device_arg = ["--device", "cpu"] if dev.type == "cpu" else []  # the card is every CLI's default
    data, mols, cache = (os.path.join(TRAIN_DIR, n) for n in ("data", "mols", "cache"))
    write_1a0q(os.path.join(data, "1a0q"))
    write_seeded_complex(os.path.join(data, "seeded"))
    n_mols = write_molecules(mols)
    overlay = dict(TRAIN_OVERLAY or {})
    cfg_arg = []
    if overlay:
        from confidence_bootstrapping_tpu_torch import yaml_io

        with open(os.path.join(TRAIN_DIR, "overlay.yml"), "w") as f:
            f.write(yaml_io.dump(overlay))
        cfg_arg = ["--config", os.path.join(TRAIN_DIR, "overlay.yml")]
    score_cfg = ScoreModelConfig(**dict(dict(lm_embedding_dim=0), **overlay))
    conf_cfg = confidence_model_config(ns=CT_NS, nv=CT_NV, lm_embedding_dim=0)
    # phase 5's and phase 6's architectures as model directories, with no ESM features: the CLIs featurize none
    dirs = {}
    for name, cfg in (("score", score_cfg), ("confidence", conf_cfg)):
        dirs[name] = os.path.join(TRAIN_DIR, name)
        checkpoints.save_model_dir(dirs[name], cfg, get_model(cfg, device=dev, seed=0))
    print(f"phase 14 inputs: 1a0q and the seeded complex as files, {n_mols} molecules as SDFs, the score model "
          f"(ns={score_cfg.ns}, nv={score_cfg.nv}, {score_cfg.num_conv_layers} trunk layers) and the confidence model "
          f"(ns={conf_cfg.ns}, lmax={conf_cfg.sh_lmax}, all-atom) as model directories, lm_dim 0", flush=True)
    marks.append(("inputs", time.perf_counter()))

    # 1. cli.train over the two complexes, conformer matching on (timed apart: the cache the CLI then reads)
    wd1 = os.path.join(TRAIN_DIR, "train")
    argv = ["--data_dir", data, "--cache_path", cache, "--workdir", wd1, "--batch_size", str(TRAIN_B), "--n_epochs",
            str(TRAIN_EPOCHS), "--val_inference_freq", "1", "--num_inference_complexes", "2", "--inference_samples",
            str(BENCH_SAMPLES), "--inference_steps", str(STEPS), "--save_model_freq", "1",
            "--inference_secondary_metric", "valinf_rmsds_lt5", "--seed", "0"] + cfg_arg + device_arg
    t0 = time.perf_counter()
    ComplexDataset(discover_dir(data), cache_dir=cache, all_atoms=score_cfg.all_atoms,
                   **train_cli._matching_kwargs(train_cli.get_parser().parse_args(argv)))
    match_s = time.perf_counter() - t0
    steps, saved, text = [], {}, io.StringIO()
    t0 = time.perf_counter()
    with counted_calls(train_loop, "make_train_step", steps), recorded_saves(saved), contextlib.redirect_stdout(text):
        state, hist = train_cli.main(argv)
    wall1 = time.perf_counter() - t0
    print(text.getvalue().rstrip(), flush=True)
    model = state.model
    epochs = ", ".join(f"{h['wall']:.3f}" for h in hist)
    print(f"cli.train, {TRAIN_EPOCHS} epochs over 1a0q and the seeded complex at batch {TRAIN_B}, the benchmark each "
          f"epoch ({BENCH_SAMPLES} poses x {STEPS} steps): wall {wall1:.3f} s, epochs {epochs} s; featurization with "
          f"conformer matching {match_s:.3f} s; benchmark {hist[-1]['inference']}", flush=True)
    steps_line("cli.train steps", steps, TRAIN_B, expected_train_launches(model))
    bad = files_back(saved)
    names = sorted(os.listdir(wd1))
    with open(os.path.join(wd1, "history.pkl"), "rb") as f:
        history_back = pickle.load(f)
    fresh = train_loop.init_train_state(get_model(model.cfg, device=dev, seed=1), TrainConfig(batch_size=TRAIN_B))
    loaded, epoch = checkpoints.load_train_state(wd1, fresh)
    same = loaded is not None and epoch == TRAIN_EPOCHS - 1 and same_snapshot(snapshot(state), snapshot(loaded))
    final = (weights_back(os.path.join(wd1, "last_model.msgpack"), model),
             weights_back(os.path.join(wd1, "last_ema_model.msgpack"), model, state.ema))
    print(f"cli.train workdir: {names}; {len(saved)} msgpack files back bit for bit: {not bad}; last_model and "
          f"last_ema_model are the final state's: {final}; the train-state bundle at epoch {epoch} bit for bit: {same}; "
          f"history.pkl as returned: {history_back == hist}", flush=True)
    if (bad or not same or history_back != hist or not all(final)
            or load_score_config(os.path.join(wd1, checkpoints.CONFIG_NAME)) != model.cfg
            or not all(np.isfinite(h["train"]["loss"]) for h in hist)):
        fail("cli.train: its workdir does not read back what it trained, or a loss is not finite")
    # a second call resumes from the bundle at epoch TRAIN_EPOCHS; one more step from the bundle matches the first's
    argv2 = [wd1 + "_2" if a == wd1 else a for a in argv] + ["--restart_dir", wd1]
    argv2[argv2.index("--n_epochs") + 1] = str(TRAIN_EPOCHS + 1)
    argv2[argv2.index("--val_inference_freq") + 1] = "0"
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        _, hist2 = train_cli.main(argv2)
    wall2 = time.perf_counter() - t0
    resumed = f"resuming at epoch {TRAIN_EPOCHS}" in text.getvalue() and [h["epoch"] for h in hist2] == [TRAIN_EPOCHS]
    step = train_loop.make_train_step(model.cfg, TrainConfig(batch_size=TRAIN_B))
    sb = replicate_complex(host_complex(0)[0], 4, device=dev)
    res = []
    for s in (state, loaded):
        m = step(s, sb, torch.Generator(device=dev).manual_seed(3))
        res.append([("loss", m["loss"].detach())] + [(f"param {n}", p.detach()) for n, p in s.model.named_parameters()]
                   + [(f"ema {n}", e) for n, e in s.ema.items()])
    checks = [(n, b, a) for (n, a), (_, b) in zip(*res) if a.numel()]
    worst = max(((g - w).abs().max().item() / (MODEL_RTOL * max(1.0, w.abs().max().item())), n) for n, g, w in checks)
    print(f"cli.train --restart_dir: resumed at epoch {TRAIN_EPOCHS} from the bundle: {resumed} (wall {wall2:.3f} s); "
          f"one more step from the bundle against the first call's state: worst error {worst[0]:.3g} of its "
          f"tolerance ({MODEL_RTOL} x max(1, max |first|)) at {worst[1]}", flush=True)
    if not (resumed and worst[0] <= 1.0):
        fail("cli.train --restart_dir did not resume the first call's state")
    argv3 = [wd1 + "_3" if a == wd1 + "_2" else a for a in argv2]
    with contextlib.redirect_stdout(io.StringIO()):
        idle = profile_run(lambda: train_cli.main(argv3), wall2 * 1e3, host_ops=False)
    print(f"cli.train, one epoch (2 steps, the validation loss) under the profiler: card idle "
          f"{'not measured' if idle is None else f'{idle:.3f}'} of the unprofiled call's {wall2:.3f} s", flush=True)
    marks.append(("cli.train", time.perf_counter()))

    # 2. cli.train --dataset torsional on the molecules
    wdt = os.path.join(TRAIN_DIR, "torsional")
    argv_t = ["--dataset", "torsional", "--torsional_data_dir", mols, "--workdir", wdt, "--batch_size", str(TORS_B),
              "--n_epochs", str(TORS_EPOCHS), "--seed", "0"] + cfg_arg + device_arg
    tsteps, text = [], io.StringIO()
    t0 = time.perf_counter()
    with counted_calls(train_loop, "make_torsional_train_step", tsteps), contextlib.redirect_stdout(text):
        tstate, thist = train_cli.main(argv_t)
    wall_t = time.perf_counter() - t0
    print(text.getvalue().rstrip(), flush=True)
    tmodel = tstate.model
    print(f"cli.train --dataset torsional, {TORS_EPOCHS} epochs at batch {TORS_B}: wall {wall_t:.3f} s; losses "
          f"{[round(h['train']['loss'], 4) for h in thist]}, validation {[round(h['val']['loss'], 4) for h in thist]}",
          flush=True)
    steps_line("torsional steps", tsteps, TORS_B, expected_torsional_launches(tmodel), "molecules/s")
    if not (all(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"]) for h in thist)
            and weights_back(os.path.join(wdt, "last_model.msgpack"), tmodel)):
        fail("cli.train --dataset torsional: a loss is not finite, or its weights do not read back")
    tcfg_t = TrainConfig(batch_size=TORS_B)
    tds = torsional.TorsionalDataset(mols, device=dev)
    # a B=2 step card against CPU at dropout 0: loss, every gradient, the batch statistics
    cfg0 = dataclasses.replace(tmodel.cfg, dropout=0.0)
    tb = tds.epoch_batches(TORS_CPU_B, np.random.RandomState(0))[0]
    draws = torsional.torsional_draw_noise(tb, cfg0.sigma, tcfg_t, torch.Generator(device=dev).manual_seed(5))
    res = []
    for device in (dev, torch.device("cpu")):
        m0 = get_model(cfg0, device=device, seed=0).requires_grad_(True)
        noised, targets = torsional.torsional_apply_draws(tb.map(lambda a: a.to(device)),
                                                          torsional.TorsionalDraws(*(d.to(device) for d in draws)),
                                                          cfg0.sigma)
        loss, _ = torsional.torsional_loss(m0.torsional_forward(noised, deterministic=False, use_running_average=False),
                                           targets, noised)
        names = [n for n, _ in m0.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in m0.named_parameters()], allow_unused=True)
        res.append((loss.detach().cpu(), {n: (torch.zeros(()) if g is None else g.cpu()) for n, g in zip(names, grads)},
                    {n: b.cpu() for n, b in m0.named_buffers()}))
    (lg, gg, bg), (lc, gc, bc) = res
    checks = [("loss", lg, lc)] + [(f"grad {n}", gg[n], gc[n]) for n in gc] + [(f"stat {n}", bg[n], bc[n]) for n in bc]
    checks = [c for c in checks if c[2].numel()]
    worst = max(((g - w).abs().max().item() / (MODEL_RTOL * max(1.0, w.abs().max().item())), n) for n, g, w in checks)
    print(f"torsional step card vs CPU (B={TORS_CPU_B}, dropout 0): loss {lg.item():.6f} vs {lc.item():.6f}; "
          f"{len(gc)} gradients and {len(bc)} batch statistics; worst error {worst[0]:.3g} of its tolerance "
          f"({MODEL_RTOL} x max(1, max |cpu|)) at {worst[1]}", flush=True)
    if not (worst[0] <= 1.0 and torch.isfinite(lg)):
        fail("torsional step: the card disagrees with the CPU")
    # every kernel call of one step and of one eval step (at the bucket: pb; at a ligand's own size: row 5), replayed
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = tds.epoch_batches(TORS_B, np.random.RandomState(1))[0]
    calls = record_train_calls(lambda: train_loop.make_torsional_train_step(tmodel.cfg, tcfg_t)(tstate, batch, gen))
    torch.cuda.synchronize()
    check_tc_builds(calls, "torsional training step")
    replay_train_kernels(calls, timed=False)
    replay_train_ops(calls, timed=False)
    hc = next(c for c in tds.complexes if len(c.lig_f) % 8)
    own = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), 1)._replace(L=len(hc.lig_f), N=1, KR=1)
    own_batch = replicate_complex(pad_complex(hc, own, lm_dim=0), TORS_B, device=dev).set_time(0.5, 0.5, 0.5)
    ecalls = record_calls(lambda: train_loop.make_torsional_eval_step(tmodel.cfg, tcfg_t)(tstate, batch, gen),
                          ("tpconv_pb", "tpconv_nbr"))
    with torch.no_grad():
        ecalls["tpconv_nbr"] += record_calls(lambda: tmodel.torsional_forward(own_batch), ("tpconv_nbr",))["tpconv_nbr"]
    torch.cuda.synchronize()
    n_emb = len(tmodel.lig_emb_layers)
    print(f"torsional eval step at L={batch.lig_pos.shape[1]}: {len(ecalls['tpconv_pb'])} pb calls; forward at the "
          f"ligand's own L={len(hc.lig_f)}: {len(ecalls['tpconv_nbr'])} row 5 calls; expected {n_emb} each", flush=True)
    if len(ecalls["tpconv_pb"]) != n_emb or len(ecalls["tpconv_nbr"]) != n_emb:
        fail("the torsional eval step did not run its ligand layers through pb and row 5")
    check_tc_builds({"tpconv_nbr": ecalls["tpconv_nbr"]}, "torsional forward at L % 8 != 0")
    replay(ecalls, dict(tpconv_pb=sample_kernels()["tpconv_pb"], tpconv_nbr=eval_kernels()["tpconv_nbr"]),
           bitwise=("tpconv_pb", "tpconv_nbr"), timed=False)
    del calls, ecalls
    marks.append(("cli.train --dataset torsional", time.perf_counter()))

    # 3. cli.bootstrap_gen with both model directories, the cutoff at the median confidence of the same draws
    gcache = os.path.join(TRAIN_DIR, "bootstrap")
    gen_argv = ["--data_dir", data, "--cache_path", gcache, "--model_dir", dirs["score"], "--confidence_model_dir",
                dirs["confidence"], "--samples_per_target", str(GEN_SAMPLES), "--inference_steps", str(STEPS),
                "--seed", "0"] + device_arg
    targets = bootstrap_gen.build_targets(bootstrap_gen.get_parser().parse_args(gen_argv), need_atoms=True)
    with contextlib.redirect_stdout(io.StringIO()):
        score_model = load_or_init_model(dirs["score"], "last_model", device=dev)[0]
        conf_model = load_or_init_model(dirs["confidence"], "last_model", device=dev)[0]
    pre = generate_bootstrapping_complexes(score_model, targets, torch.Generator(device=dev).manual_seed(0),
                                           score_model.cfg, GEN_SAMPLES, STEPS, ft.confidence_function(conf_model),
                                           -np.inf, device=dev)
    confs = np.asarray([c for _, _, c in pre])
    cutoff = float(np.median(confs))
    band = MODEL_RTOL * max(1.0, float(np.abs(confs).max()))
    rounds, text = [], io.StringIO()
    t0 = time.perf_counter()
    with counted_calls(bootstrap_gen, "generate_bootstrapping_complexes", rounds, factory=False), \
            contextlib.redirect_stdout(text):
        kept = bootstrap_gen.main(gen_argv + ["--confidence_cutoff", repr(cutoff)])
    wall_g = time.perf_counter() - t0
    print(text.getvalue().rstrip(), flush=True)
    pkl = os.path.join(gcache, "complexes_id1.pkl")
    with open(pkl, "rb") as f:
        back = pickle.load(f)
    equal = len(back) == len(kept) and all(n == m and c == d and all(np.array_equal(p[k], q[k]) for k in p)
                                           for (p, n, c), (q, m, d) in zip(back, kept))
    got_c = np.asarray([c for _, _, c in kept])
    want_n = (int((confs > cutoff + band).sum()), int((confs > cutoff - band).sum()))
    want_l = {k: 2 * v for k, v in nonzero(dict(expected_launches(score_model, STEPS),
                                                 **expected_conf_launches(conf_model))).items()}
    print(f"cli.bootstrap_gen, 2 targets x {GEN_SAMPLES} poses x {STEPS} steps, cutoff {cutoff:.4f} (the median of "
          f"the same draws): wall {wall_g:.3f} s ({2 * GEN_SAMPLES / wall_g:.3f} rollout poses/s); kept {len(kept)} "
          f"(the same draws above the cutoff, off a band of {band:.2g}: {want_n[0]}-{want_n[1]}), every kept "
          f"confidence above it: {bool((got_c > cutoff).all())}; {os.path.basename(pkl)} back: {equal}; launches "
          f"{rounds[0]['launches'] if rounds else None}, expected from the config {want_l}", flush=True)
    if not (equal and want_n[0] <= len(kept) <= want_n[1] and (got_c > cutoff).all() and len(kept)
            and rounds and rounds[0]["launches"] == want_l):
        fail("cli.bootstrap_gen did not keep the poses above the cutoff, or its pickle does not read back")
    # then cli.train with the pickle mixed in
    argv_b = [os.path.join(TRAIN_DIR, "train_boot") if a == wd1 else a for a in argv] + [
        "--add_bootstrapping_dataset", pkl]
    argv_b[argv_b.index("--n_epochs") + 1] = "1"
    argv_b[argv_b.index("--val_inference_freq") + 1] = "0"
    bsteps, text = [], io.StringIO()
    t0 = time.perf_counter()
    with counted_calls(train_loop, "make_train_step", bsteps), contextlib.redirect_stdout(text):
        _, bhist = train_cli.main(argv_b)
    wall_b = time.perf_counter() - t0
    mixed = [line for line in text.getvalue().splitlines() if "bootstrapped" in line]
    print(f"cli.train --add_bootstrapping_dataset, one epoch: wall {wall_b:.3f} s; {mixed}; loss "
          f"{bhist[0]['train']['loss']:.4f}", flush=True)
    steps_line("cli.train steps with the bootstrapped poses", bsteps, TRAIN_B, expected_train_launches(model))
    if not (mixed and np.isfinite(bhist[0]["train"]["loss"]) and len(bsteps) > len(steps) // TRAIN_EPOCHS):
        fail("cli.train --add_bootstrapping_dataset did not train on the bootstrapped poses")
    marks.append(("cli.bootstrap_gen and cli.train on its pickle", time.perf_counter()))

    # 4. cli.finetune with both model directories: one epoch, one rollout round, the same cutoff
    wdf = os.path.join(TRAIN_DIR, "finetune")
    rounds, fsteps, text = [], [], io.StringIO()
    t0 = time.perf_counter()
    with counted_calls(ft, "inference_epoch", rounds, factory=False), counted_calls(train_loop, "make_train_step", fsteps), \
            contextlib.redirect_stdout(text):
        fstate, fhist = finetune.main(["--data_dir", data, "--cache_path", cache, "--workdir", wdf, "--model_dir",
                                       dirs["score"], "--confidence_model_dir", dirs["confidence"], "--n_epochs", "1",
                                       "--inference_samples", str(GEN_SAMPLES), "--inference_steps", str(STEPS),
                                       "--initial_iterations", "1", "--fixed_length", str(FT_FIXED),
                                       "--batch_size", str(TRAIN_B), "--confidence_cutoff", repr(cutoff),
                                       "--seed", "0"] + device_arg)
    wall_f = time.perf_counter() - t0
    print(text.getvalue().rstrip(), flush=True)
    inf = fhist[0]["inference"]
    print(f"cli.finetune, one epoch ({GEN_SAMPLES} poses a target x {STEPS} steps, fixed_length {FT_FIXED}): wall "
          f"{wall_f:.3f} s; round {rounds[0]['wall'] if rounds else float('nan'):.3f} s, kept {inf['n_kept']} of "
          f"{inf['n_sampled']}, failures {inf['failures']}; launches per round {rounds[0]['launches'] if rounds else None},"
          f" expected from the config {want_l}", flush=True)
    steps_line("cli.finetune steps", fsteps, TRAIN_B, expected_train_launches(fstate.model))
    back = (weights_back(os.path.join(wdf, "last_model.msgpack"), fstate.model)
            and weights_back(os.path.join(wdf, "ema_model.msgpack"), fstate.model, fstate.ema))
    with open(os.path.join(wdf, "metrics.pkl"), "rb") as f:
        metrics_back = len(pickle.load(f)) == len(fhist)
    print(f"cli.finetune workdir {sorted(os.listdir(wdf))}: last_model and ema_model back bit for bit: {back}; "
          f"metrics.pkl: {metrics_back}", flush=True)
    if not (len(rounds) == 1 and rounds[0]["launches"] == want_l and inf["failures"] == 0 and inf["n_kept"] > 0
            and len(fsteps) == FT_FIXED // TRAIN_B and back and metrics_back):
        fail("cli.finetune: a round failed, the launches differ from the config, or the workdir does not read back")
    marks.append(("cli.finetune", time.perf_counter()))

    # 5. cli.confidence_train at phase 6's architecture: a cache, one epoch of CT_BATCHES batches, then --test
    wdc = os.path.join(TRAIN_DIR, "confidence")
    # 1a0q alone: FilteringDataset stacks its picks into one batch, so its targets share a bucket (in both packages)
    base = ["--data_dir", data, "--cache_path", cache, "--workdir", wdc, "--original_model_dir", dirs["score"],
            "--limit_complexes", "1", "--inference_steps", str(STEPS), "--ns", str(CT_NS), "--nv", str(CT_NV),
            "--seed", "0"] + device_arg
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        confidence_train.main(base + ["--samples_per_complex", str(CT_SAMPLES), "--cache_creation_id", "1"])
    wall_cache = time.perf_counter() - t0
    csteps = []
    t0 = time.perf_counter()
    with counted_calls(ctrain, "make_confidence_train_step", csteps), contextlib.redirect_stdout(text):
        cstate, chist = confidence_train.main(base + ["--samples_per_complex", str(CT_SAMPLES), "--n_epochs", "1",
                                                      "--batches_per_epoch", str(CT_BATCHES), "--batch_size",
                                                      str(TRAIN_B), "--cache_ids", "1"])
    wall_c = time.perf_counter() - t0
    print(text.getvalue().rstrip(), flush=True)
    with contextlib.redirect_stdout(io.StringIO()):
        loaded_c, loaded_cfg = load_or_init_model(wdc, "last_model", device=dev)
    same_c = (loaded_cfg == cstate.model.cfg
              and all(torch.equal(a, b) for a, b in zip(loaded_c.state_dict().values(),
                                                        cstate.model.state_dict().values())))
    val = chist[0]["val"]
    print(f"cli.confidence_train: the cache ({CT_SAMPLES} poses a complex x {STEPS} steps) {wall_cache:.3f} s, one "
          f"epoch of {CT_BATCHES} batches at {TRAIN_B} {wall_c:.3f} s; validation {val}; the workdir "
          f"{sorted(os.listdir(wdc))} loads onto the card bit for bit: {same_c}", flush=True)
    steps_line("cli.confidence_train steps", csteps, TRAIN_B, expected_conf_train_launches(cstate.model))
    if not (same_c and np.isfinite(val["loss"]) and len(csteps) == CT_BATCHES):
        fail("cli.confidence_train: the workdir does not load back, or the validation loss is not finite")
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        sweep = confidence_train.main(base + ["--samples_per_complex", str(CT_TEST_SAMPLES), "--test"])
    wall_test = time.perf_counter() - t0
    print(f"cli.confidence_train --test ({CT_TEST_SAMPLES} poses, {STEPS} steps): {wall_test:.3f} s; accuracy at steps "
          f"0 / {STEPS}: {sweep[0]['accuracy']:.3f} / {sweep[-1]['accuracy']:.3f}, mean RMSD {sweep[-1]['mean_rmsd']:.3f} "
          f"A (random weights)", flush=True)
    if len(sweep) != STEPS + 1 or not all(np.isfinite(r["mean_rmsd"]) and np.isfinite(r["mean_score"]) for r in sweep):
        fail("cli.confidence_train --test: the sweep is not finite or not of the expected length")
    marks.append(("cli.confidence_train", time.perf_counter()))
    print("phase 14 walls: " + ", ".join(f"{name} {t - t_prev:.1f} s" for (_, t_prev), (name, t) in zip(marks, marks[1:]))
          + f"; in all {marks[-1][1] - marks[0][1]:.1f} s", flush=True)


# ----------------------------------------------------------------------------- phase 15: reference checkpoints


def reference_state_dict(model) -> dict:
    """The reference's ``state_dict`` (e3nn layout, numpy float32) of a
    port model: the inverse of ``models.convert.convert_state_dict`` for the
    four architectures. Linears as [out, in] inside their ``Sequential``
    indices, the last Dense of each TP-conv's edge MLP in e3nn's
    instruction-major column order, e3nn BatchNorm buffers (one running
    variance per irrep instance), ``atom_embedding_list`` tables and the
    legacy encoders' ``linear``/``lm_embedding_layer``; the legacy all-atom
    model's groups in the reference's flat ``conv_layers`` list, 9 a depth."""
    from confidence_bootstrapping_tpu_torch.models import convert, from_flax
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv
    from confidence_bootstrapping_tpu_torch.models.legacy import LEGACY_AA_GROUPS
    from confidence_bootstrapping_tpu_torch.ops.irreps import Irreps

    cfg = model.cfg
    legacy = cfg.old_score_model
    tree = from_flax.flax_from_state_dict(model)
    params, stats = tree["params"], tree.get("batch_stats", {})
    sd = {}

    def linear(ref, d):
        sd[f"{ref}.weight"] = d["kernel"].T
        if "bias" in d:
            sd[f"{ref}.bias"] = d["bias"]

    def fcblock(ref, d, perm=None):
        n = len([k for k in d if k.startswith("Dense_")])
        for j in range(n):
            lin = dict(d[f"Dense_{j}"])
            if perm is not None and j == n - 1:  # e3nn's order: ours = e3nn[perm]
                inv = np.argsort(perm)
                lin = {k: (v[:, inv] if k == "kernel" else v[inv]) for k, v in lin.items()}
            linear(f"{ref}.{3 * j}", lin)

    def batch_norm(ref, p, st, irreps):
        sd[f"{ref}.weight"], sd[f"{ref}.bias"], sd[f"{ref}.running_mean"] = p["weight"], p["bias"], st["mean"]
        var, norm, chunks = list(st["var"]), list(st["norm"]), []
        for mul, ir in Irreps(irreps):
            src = var if (ir.l == 0 and ir.p == 1) else norm
            chunks.append(np.asarray([src.pop(0) for _ in range(mul)], np.float32))
        sd[f"{ref}.running_var"] = np.concatenate(chunks)

    for name, d in params.items():
        if name.endswith("_node_embedding"):
            for k, v in d.items():
                if k.startswith("Embed_"):
                    sd[f"{name}.atom_embedding_list.{k.split('_')[1]}.weight"] = v["embedding"]
            dense = (("linear", "lm_embedding_layer") if legacy and cfg.use_old_atom_encoder
                     else ("additional_features_embedder",))
            for j, ref in enumerate(dense):
                if f"Dense_{j}" in d:
                    linear(f"{name}.{ref}", d[f"Dense_{j}"])
        elif name.endswith("_embedding"):
            fcblock(name, d)
        elif name in ("tr_final_layer", "rot_final_layer", "tor_final_layer"):
            for j, idx in enumerate((0, 3)):
                linear(f"{name}.{idx}", d[f"Dense_{j}"])
        elif name.endswith("_predictor"):
            for j, idx in enumerate((0, 4, 8)):
                linear(f"{name}.{idx}", d[f"Dense_{j}"])
            for j, idx in enumerate((1, 5)):
                k = f"MaskedBatchNorm1d_{j}"
                if k in d:
                    sd[f"{name}.{idx}.weight"], sd[f"{name}.{idx}.bias"] = d[k]["scale"], d[k]["bias"]
                    sd[f"{name}.{idx}.running_mean"] = stats[name][k]["mean"]
                    sd[f"{name}.{idx}.running_var"] = stats[name][k]["var"]
    for name, mod in model.named_modules():
        if not isinstance(mod, TPConv):
            continue
        flax_name = name.replace(".", "_")
        ref = name
        if legacy and cfg.all_atoms and "." in name:
            group, depth = name.split(".")
            ref = f"conv_layers.{9 * int(depth) + LEGACY_AA_GROUPS.index(group)}"
        kind = {"final_conv": "final", "tor_bond_conv": "tor"}.get(name, "trunk")
        perm = convert.tp_perm_for_layer(cfg, mod.in_irreps, mod.out_irreps, kind, force_generic=legacy)
        p = params[flax_name]
        n_groups = len([k for k in p if k.startswith("edge_mlps_")])
        for g in range(n_groups):
            fcblock(f"{ref}.fc" if n_groups == 1 else f"{ref}.fc.{g}", p[f"edge_mlps_{g}"], perm)
        if "bn" in p:
            batch_norm(f"{ref}.batch_norm", p["bn"], stats[flax_name]["bn"], mod.out_irreps)
    return sd


LEGACY_DIR = os.path.join(ROOT, "build", "legacy")  # reference files, converted directories, 1a0q, workdirs; removed
LEGACY_SCORE = dict(ns=48, nv=10, num_conv_layers=6, sh_lmax=2)  # DiffDock's published score model
LEGACY_B, LEGACY_CPU_STEPS = 8, 1  # infer's batch of poses; the card-vs-CPU sample's steps
AFF_SAMPLES, AFF_BATCH, AFF_BATCHES, AFF_CPU_B = 4, 16, 2, 8  # the affinity runs' cache, batch, steps; CPU check batch
AFF_CPU_LAYERS = 4  # the card-vs-CPU step's trunk depth: 24 -> 42 -> 60 -> 84 -> 84, every layout of the 5-layer model


def reference_manifest(cfg) -> dict:
    """The reference's ``model_parameters.yml`` (its flag names) of a
    config; ``config_from_reference_manifest`` must give the config back
    (the legacy flag aside: the reference names it at inference)."""
    import dataclasses

    from confidence_bootstrapping_tpu_torch.models import factory

    m = {src: getattr(cfg, dst) for src, dst in factory._DIRECT.items()}
    m.update({src: not getattr(cfg, dst) for src, dst in factory._INVERTED.items()})
    m.update({k: getattr(cfg.sigma, k) for k in factory._SIGMAS})
    m["esm_embeddings_path"] = "esm2_embeddings.pt" if cfg.lm_embedding_dim else None
    if cfg.confidence_mode:
        m["rmsd_classification_cutoff"] = 2.0
        if cfg.atom_confidence:
            m["atom_confidence_loss_weight"] = 0.5
    back = dataclasses.replace(factory.config_from_reference_manifest(m), old_score_model=cfg.old_score_model)
    if back != cfg:
        fail(f"the reference manifest does not translate back to the config: {back} != {cfg}")
    return m


def write_reference(d: str, model) -> dict:
    """``model`` as the reference ships it, into ``d``: its manifest and its
    state dict (``reference_state_dict``) as raw.pt, bundle.pt (``{epoch,
    model, optimizer, ema_weights}``, the EMA weights half the live ones, in
    the parameters' order) and module.pt (DataParallel's ``module.``
    prefix). -> the EMA parameters by the port's names."""
    import torch

    from confidence_bootstrapping_tpu_torch import yaml_io
    from confidence_bootstrapping_tpu_torch.cli.convert import BUFFERS

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "model_parameters.yml"), "w") as f:
        f.write(yaml_io.dump(reference_manifest(model.cfg)))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in reference_state_dict(model).items()}
    shadow = [v * 0.5 for k, v in sd.items() if not k.endswith(BUFFERS)]
    torch.save(sd, os.path.join(d, "raw.pt"))
    torch.save({"epoch": 7, "model": sd, "optimizer": {}, "ema_weights": {"shadow_params": shadow}},
               os.path.join(d, "bundle.pt"))
    torch.save({f"module.{k}": v for k, v in sd.items()}, os.path.join(d, "module.pt"))
    return {n: p.detach() * 0.5 for n, p in model.named_parameters()}


def convert_and_load(d: str, model, dev, module_run: bool = False):
    """Phase 15b: ``cli.convert`` on each file ``write_reference`` wrote
    (live, and the bundle with ``--use_ema``), each result loaded onto the
    card with ``cli.dock.load_or_init_model``: every parameter and buffer
    bit for bit against the source model (the EMA: half its parameters, its
    buffers). With ``module_run`` the raw file once more through ``python -m
    confidence_bootstrapping_tpu_torch.cli.convert`` (the same bytes).
    Returns the loaded model of raw.pt."""
    import contextlib
    import io
    import subprocess

    import torch

    from confidence_bootstrapping_tpu_torch.cli import convert as convert_cli
    from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model

    half = write_reference(d, model)
    flag = ["--old_score_model"] if model.cfg.old_score_model else []
    first = None
    for layout, extra in (("raw", []), ("bundle", []), ("module", []), ("bundle", ["--use_ema"])):
        out = os.path.join(d, layout + ("_ema" if extra else ""))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_cli.main(["--checkpoint", os.path.join(d, f"{layout}.pt"), "--out_dir", out] + flag + extra)
            t_conv = time.perf_counter() - t0
            loaded, cfg = load_or_init_model(out, "last_model", device=dev)
        if extra:
            same = (all(torch.equal(p, half[n]) for n, p in loaded.named_parameters())
                    and all(torch.equal(b, model.get_buffer(n)) for n, b in loaded.named_buffers()))
        else:
            same = state_equal(model, loaded)
        same = same and cfg == model.cfg
        print(f"  {os.path.basename(d)} {layout}.pt{' --use_ema' if extra else ''}: converted in {t_conv:.2f} s "
              f"({os.path.getsize(os.path.join(out, 'last_model.msgpack'))} bytes), loaded onto the card, every "
              f"parameter and buffer bit for bit{' (the EMA weights)' if extra else ''}: {same}", flush=True)
        if not same:
            fail(f"{d}/{layout}.pt did not convert and load back bit for bit")
        first = first or loaded
    if module_run:
        out = os.path.join(d, "raw_cli")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "confidence_bootstrapping_tpu_torch.cli.convert", "--checkpoint",
                            os.path.join(d, "raw.pt"), "--out_dir", out] + flag, cwd=ROOT, capture_output=True,
                           text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
        same = r.returncode == 0 and all(
            open(os.path.join(out, f), "rb").read() == open(os.path.join(d, "raw", f), "rb").read()
            for f in ("model_config.yml", "last_model.msgpack"))
        print(f"  python -m confidence_bootstrapping_tpu_torch.cli.convert on raw.pt: {time.perf_counter() - t0:.1f} s, "
              f"the same files: {same} ({r.stdout.strip()[-120:]})", flush=True)
        if not same:
            fail(f"the convert module's entry point failed or wrote other files: {r.stderr[-2000:]}")
    return first


def messages_routes(models: dict, run):
    """(run()'s result, {layer: {route: calls}}): every inference call of a
    TP-conv's ``messages`` in ``models`` ({prefix: model}, which ``run`` may
    fill) recorded with the route its layer takes (``TPConv.edge_build``:
    the edge-list kernel's tensor-core or float32 build, or the plain TP of
    a layer without ``edge_kernel``)."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    names = {}
    routes = {}
    orig = TPConv.messages

    def messages(self, group, sender, sh, attr, mask, deterministic=True, generator=None, edge_weight=None):
        if id(self) not in names:
            names.update({id(m): f"{prefix}.{n}" for prefix, model in models.items() for n, m in model.named_modules()})
        if deterministic and id(self) in names:
            b = self.edge_build(mask.shape[-1]) if self.edge_kernel else None
            route = "plain TP" if b is None else ("tensor cores" if b[0] else f"float32 at {b[1]}")
            d = routes.setdefault(names[id(self)], {})
            d[route] = d.get(route, 0) + 1
        return orig(self, group, sender, sh, attr, mask, deterministic, generator, edge_weight)

    TPConv.messages = messages
    try:
        return run(), routes
    finally:
        TPConv.messages = orig


def expected_legacy_launches(model, forwards: int) -> int:
    """Edge-list kernel launches of ``forwards`` inference forwards of a
    legacy model whose every trunk layer fits a build: per depth the
    ligand's pairs, bonds and cross lists (one list from residues, or from
    residues and atoms in the all-atom model), and but at the last depth the
    receptor kNN and the flipped lists (all-atom: atom and residue kNN, atom
    <- ligand, atom <- residue, residue <- ligand, residue <- atom); in
    score mode the center convolution (the lmax=2 torsion head's harmonics
    take the plain TP)."""
    n = len(model.lig_conv_layers)
    per = (4 * n + 6 * (n - 1)) if model.cfg.all_atoms else (3 * n + 2 * (n - 1))
    return forwards * (per + (0 if model.cfg.confidence_mode else 1))


def edge_kernels_per_edge() -> dict:
    """The edge-list kernel's per-edge calls (the legacy models at
    inference), as ``replay`` takes them."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge

    return {"tpconv_edge": (tpconv_edge.fused_tpconv_edge, lambda *a: tpconv_edge.tpconv_edge_plain(*a, sum_k=False),
                            lambda a: edge_work(tuple(a[:11]) + (None, False)), TRAIN_KERNELS["tpconv_edge"][1])}


def check_masked_messages(calls: list) -> None:
    """Fails unless every recorded per-edge call gives its masked edges exact zeros."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge

    for a, kw in calls:
        if not bool((tpconv_edge.fused_tpconv_edge(*a, **kw)[~a[3]] == 0).all()):
            fail("the edge-list kernel gave a masked edge a message")


def relu_units(model, run):
    """(run()'s result, {edge MLP first layer's name: hidden units}): every
    call of a TP-conv in ``model`` on each route training takes
    (``messages``, the edge-list op ``_edge_list`` and the kNN conv
    ``conv_rec``, its MLP inputs gathered as its plain route gathers them)
    checked for valid edges with a hidden pre-activation within RELU_GUARD of
    zero. There two devices, summing in other orders, may take different
    sides of the ReLU, and that unit's first-layer gradient then differs by a
    whole edge's term (the kernel replays leave such edges out,
    ``near_relu_boundary``)."""
    import torch

    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    names = {id(m): n for n, m in model.named_modules()}
    found = {}
    real = {k: getattr(TPConv, k) for k in ("messages", "_edge_list", "conv_rec")}

    def note(self, group, attr, mask):
        if id(self) not in names:
            return
        w1, b1 = self.mlp_weights(group)[:2]
        with torch.no_grad():
            lead = torch.broadcast_shapes(attr.shape[:-1], mask.shape)
            z = attr.expand(lead + attr.shape[-1:])[mask.expand(lead)]
            near = ((z @ w1 + b1).abs() < RELU_GUARD * (z.abs() @ w1.abs() + b1.abs())).any(0)
        if near.any():
            key = f"{names[id(self)]}.edge_mlps.{group}.layers.0"
            found[key] = sorted(set(found.get(key, [])) | set(torch.nonzero(near)[:, 0].tolist()))

    def messages(self, group, sender, sh, attr, mask, *a, **k):
        note(self, group, attr, mask)
        return real["messages"](self, group, sender, sh, attr, mask, *a, **k)

    def edge_list(self, group, sender, sh, attr, mask, *a, **k):
        note(self, group, attr, mask)
        return real["_edge_list"](self, group, sender, sh, attr, mask, *a, **k)

    def conv_rec(self, group, node_attr, pos, nbr, edge_emb, sig, nbr_mask, *a, **k):
        with torch.no_grad():
            attr = self._gathered(node_attr, pos, node_attr, pos, nbr, edge_emb + sig[:, None, None, :],
                                  edge_emb.shape[-1])[2]
        note(self, group, attr, nbr_mask)
        return real["conv_rec"](self, group, node_attr, pos, nbr, edge_emb, sig, nbr_mask, *a, **k)

    TPConv.messages, TPConv._edge_list, TPConv.conv_rec = messages, edge_list, conv_rec
    try:
        return run(), found
    finally:
        for k, fn in real.items():
            setattr(TPConv, k, fn)


def relu_excused(gg: dict, gc: dict, at_relu: dict, float64_grads) -> tuple:
    """Card gradients ``gg`` against CPU gradients ``gc`` (host tensors by
    parameter name), each within MODEL_RTOL x max(1, max |cpu|). A tensor
    off it only at rows that are hidden units at the ReLU on the card
    (``at_relu``, from ``relu_units``: the unit's pre-activation may round to
    the other side on one device, and its first-layer gradient then differs
    by a whole edge's term) has each such row excused where float64 on the
    CPU (``float64_grads()``, run only then) sides with one of the two
    float32 devices. -> (worst (share of its tolerance, name), the excused
    rows, the float64 reading); the callers allow at most 4 excused rows."""
    import torch

    worst, candidates = (0.0, ""), {}
    for n, w in gc.items():
        g = gg[n]
        if not w.numel():
            continue
        tol = MODEL_RTOL * max(1.0, w.abs().max().item())
        off = ((g - w).abs() > tol).reshape(len(w), -1).any(-1) if w.ndim else (g - w).abs() > tol
        rows = set(torch.nonzero(off.reshape(-1))[:, 0].tolist())
        if rows and rows <= set(at_relu.get(n.rsplit(".", 1)[0], [])):
            candidates[n] = (sorted(rows), tol)
            continue
        worst = max(worst, ((g - w).abs().max().item() / tol, f"grad {n}"))
    excused, reading = [], []
    if candidates:
        g64 = float64_grads()
        for n, (rows, tol) in candidates.items():
            for r in rows:
                e_card, e_cpu = ((x[n][r].double() - g64[n][r].cpu()).abs().max().item() / tol for x in (gg, gc))
                reading.append(f"{n} row {r}: card {e_card:.3g}, CPU {e_cpu:.3g} of the tolerance from float64")
                if min(e_card, e_cpu) <= 1.0:
                    excused.append(f"{n} row {r}")
                else:
                    worst = max(worst, (min(e_card, e_cpu), f"grad {n} row {r} (against float64)"))
    return worst, excused, reading


def legacy_phase(dev, score_model, conf_model, b0, final_pos, rerank, card: str, pos_tol: float) -> None:
    """Phase 15: reference checkpoints converted and served, and the legacy
    models (see the module docstring). Every line printed carries ``card``."""
    import contextlib
    import shutil

    with contextlib.redirect_stdout(Tagged(sys.stdout, card)):
        shutil.rmtree(LEGACY_DIR, ignore_errors=True)
        try:
            legacy_run(dev, score_model, conf_model, b0, final_pos, rerank, pos_tol)
        finally:
            shutil.rmtree(LEGACY_DIR, ignore_errors=True)


def legacy_run(dev, score_model, conf_model, b0, final_pos, rerank, pos_tol: float) -> None:
    import contextlib
    import io
    import json
    import pickle

    import torch

    from confidence_bootstrapping_tpu_torch.cli import confidence_train, infer
    from confidence_bootstrapping_tpu_torch.cli.dock import load_or_init_model
    from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig, confidence_model_config
    from confidence_bootstrapping_tpu_torch.confidence import dataset as cdataset
    from confidence_bootstrapping_tpu_torch.confidence import train as ctrain
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler.sampling import sample, score_confidence
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    marks = [("start", time.perf_counter())]
    cpu = torch.device("cpu")
    device_arg = ["--device", "cpu"] if dev.type == "cpu" else []

    # a, b: phase 5's and phase 6's models as reference files, converted and loaded back
    print("15a/b. reference checkpoints of phase 5's and phase 6's models (three layouts, EMA weights) converted "
          "and loaded onto the card:", flush=True)
    loaded = {name: convert_and_load(os.path.join(LEGACY_DIR, name), m, dev, module_run=name == "score")
              for name, m in (("score", score_model), ("confidence", conf_model))}
    marks.append(("convert", time.perf_counter()))
    # c: phase 10's dock path from the converted directories
    dock_from(loaded["score"], loaded["confidence"], b0, final_pos, rerank, "the converted reference checkpoints",
              pos_tol)
    del loaded
    torch.cuda.empty_cache()
    marks.append(("dock", time.perf_counter()))

    # d: the legacy models, seeded, through the same files and the converter
    leg_cfg = ScoreModelConfig(lm_embedding_dim=0, old_score_model=True, **LEGACY_SCORE)
    leg_conf_cfg = confidence_model_config(lm_embedding_dim=0, old_score_model=True)
    print(f"15d. the legacy score model (ns={leg_cfg.ns}, nv={leg_cfg.nv}, {leg_cfg.num_conv_layers} layers, "
          f"sh_lmax={leg_cfg.sh_lmax}) and the legacy all-atom confidence model (ns={leg_conf_cfg.ns}, "
          f"nv={leg_conf_cfg.nv}, {leg_conf_cfg.num_conv_layers} layers, sh_lmax={leg_conf_cfg.sh_lmax}), seeded, "
          f"lm 0:", flush=True)
    leg = convert_and_load(os.path.join(LEGACY_DIR, "legacy_score"), get_model(leg_cfg, device=dev, seed=0), dev)
    leg_conf = convert_and_load(os.path.join(LEGACY_DIR, "legacy_confidence"),
                                get_model(leg_conf_cfg, device=dev, seed=0), dev)
    for name, m in (("score", leg), ("confidence", leg_conf)):  # the route each layer takes, at 24- and 1-edge lists
        for layer, mod in m.named_modules():
            if hasattr(mod, "edge_build"):
                print(f"  legacy {name} {layer}: {mod.in_irreps} -> {mod.out_irreps}, H={mod.hidden}, sh "
                      f"{mod.sh_irreps}: {edge_route_line(mod, 24)}", flush=True)
    marks.append(("legacy convert", time.perf_counter()))

    # B=2 forwards and a LEGACY_CPU_STEPS-step B=8 ODE sample, card against CPU
    padded = host_complex(0)[0]
    padded_aa = host_complex(0, all_atoms=True)[0]
    rng = np.random.RandomState(5)
    pos2 = padded["lig_pos"][None] + rng.randn(2, *padded["lig_pos"].shape).astype(np.float32) * 2
    pos8 = padded["lig_pos"][None] + rng.randn(LEGACY_B, *padded["lig_pos"].shape).astype(np.float32) * 2
    near = near_crystal_poses(padded_aa, 2).numpy()
    res = {}
    for device, (sm, cm) in ((dev, (leg, leg_conf)), (cpu, (None, None))):
        if sm is None:
            sm, cm = get_model(leg_cfg, device=cpu, seed=0), get_model(leg_conf_cfg, device=cpu, seed=0)
            sm.load_state_dict(leg.state_dict())
            cm.load_state_dict(leg_conf.state_dict())
        b2 = replicate_complex(padded, 2, device=device).replace(lig_pos=torch.as_tensor(pos2, device=device))
        b8 = replicate_complex(padded, LEGACY_B, device=device).replace(lig_pos=torch.as_tensor(pos8, device=device))
        ba = replicate_complex(padded_aa, 2, device=device)
        t0 = time.perf_counter()
        out = sm(b2.set_time(0.5, 0.5, 0.5))
        conf = score_confidence(cm, ba, lig_pos=torch.as_tensor(near, device=device))
        final, _ = sample(sm, b8, leg_cfg, SamplerConfig(inference_steps=LEGACY_CPU_STEPS, ode=True), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        res[device.type] = ([t.cpu() for t in out[:3]] + [conf.cpu()], final.lig_pos.cpu(), time.perf_counter() - t0)
    (got, got_pos, t_card), (want, want_pos, t_cpu) = res[dev.type], res["cpu"]
    for name, g, w in zip(("tr_pred", "rot_pred", "tor_pred", "legacy confidence"), got, want):
        err, peak = (g - w).abs().max().item(), w.abs().max().item()
        print(f"  legacy forward B=2 {name}: max_abs_err {err:.3g} (max |cpu| {peak:.3g}, tolerance {MODEL_RTOL} x "
              f"max(1, max |cpu|))", flush=True)
        if not (err <= MODEL_RTOL * max(1.0, peak) and torch.isfinite(g).all()):
            fail(f"legacy forward {name}: the card disagrees with the CPU")
    err = (got_pos - want_pos).abs().max().item()
    print(f"  legacy {LEGACY_CPU_STEPS}-step ODE sample at B={LEGACY_B}: max_abs_err {err:.3g} A (tolerance "
          f"{SAMPLE_ATOL} A); card {t_card:.1f} s, CPU {t_cpu:.1f} s", flush=True)
    if not err <= SAMPLE_ATOL:
        fail("the legacy sample on the card disagrees with the CPU")
    marks.append(("card vs CPU", time.perf_counter()))

    # cli.infer --old_score_model on 1a0q: one batch of LEGACY_B poses x STEPS steps and the rerank
    data = os.path.join(LEGACY_DIR, "data")
    write_1a0q(os.path.join(data, "1a0q"))
    argv = ["--data_dir", data, "--model_dir", os.path.join(LEGACY_DIR, "legacy_score", "raw"),
            "--confidence_model_dir", os.path.join(LEGACY_DIR, "legacy_confidence", "raw"), "--old_score_model",
            "--samples_per_complex", str(LEGACY_B), "--batch_size", str(LEGACY_B), "--inference_steps", str(STEPS),
            "--out_dir", os.path.join(LEGACY_DIR, "infer")] + device_arg
    text = io.StringIO()
    loaded_by_infer = {}
    load = infer.load_or_init_model

    def load_and_name(model_dir, *a, **kw):  # the CLI's own models, named for messages_routes
        out = load(model_dir, *a, **kw)
        loaded_by_infer["score" if model_dir == argv[3] else "confidence"] = out[0]
        return out

    for i in range(2):  # the first call builds the so3/torus tables and the weight packs
        before = read_counters()
        t0 = time.perf_counter()
        infer.load_or_init_model = load_and_name
        try:
            with contextlib.redirect_stdout(text):
                metrics, routes = messages_routes(loaded_by_infer, lambda: infer.main(argv))
        finally:
            infer.load_or_init_model = load
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = nonzero(launch_diff(before, read_counters()))
    want = expected_legacy_launches(leg, STEPS) + expected_legacy_launches(leg_conf, 1)
    kernel_calls = sum(n for r in routes.values() for k, n in r.items() if k != "plain TP")
    plain = {k: r["plain TP"] for k, r in routes.items() if "plain TP" in r}
    by_route = {}
    for r in routes.values():
        for k, n in r.items():
            by_route[k] = by_route.get(k, 0) + n
    print(f"  cli.infer --old_score_model (1a0q, {LEGACY_B} poses x {STEPS} steps, the legacy rerank): {wall:.2f} s "
          f"(second call), failures {metrics['failures']}, rmsds_below_2 {metrics.get('rmsds_below_2')}; messages by "
          f"route {by_route}, plain TP at {plain}; launches {launches}, kernel-routed calls {kernel_calls}, expected "
          f"from the config {want}", flush=True)
    if not (metrics["failures"] == 0 and launches == {"tpconv_edge": want} and kernel_calls == want):
        fail("cli.infer --old_score_model: a failure, or the legacy models did not run their layers on the kernel")
    if any(k.startswith("confidence.") and set(r) != {"tensor cores"} for k, r in routes.items()):
        fail("a layer of the ns=24 legacy all-atom model did not take a tensor-core build")
    marks.append(("cli.infer", time.perf_counter()))

    # one sample and one rerank recorded: every edge-list call replayed through kernel and plain version
    b8 = replicate_complex(padded, LEGACY_B, device=dev).replace(lig_pos=torch.as_tensor(pos8, device=dev))
    scfg = SamplerConfig(inference_steps=STEPS)
    run = lambda: sample(leg, b8, leg_cfg, scfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    run()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = run()[0]
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    ba = replicate_complex(padded_aa, LEGACY_B, device=dev)
    t0 = time.perf_counter()
    confs = score_confidence(leg_conf, ba, lig_pos=final.lig_pos)
    torch.cuda.synchronize()
    t_rerank = time.perf_counter() - t0
    calls = record_calls(run, ("tpconv_edge",))
    calls_c = record_calls(lambda: score_confidence(leg_conf, ba, lig_pos=final.lig_pos), ("tpconv_edge",))
    torch.cuda.synchronize()
    print(f"  legacy sample at B={LEGACY_B}, {STEPS} steps: {t_sample:.3f} s, {LEGACY_B / t_sample:.3f} poses/s; the "
          f"legacy rerank {t_rerank * 1e3:.1f} ms, confidences finite: {bool(torch.isfinite(confs).all())}; recorded "
          f"{len(calls['tpconv_edge'])} + {len(calls_c['tpconv_edge'])} edge-list calls", flush=True)
    builds = edge_builds({"tpconv_edge": calls["tpconv_edge"] + calls_c["tpconv_edge"]})
    print(f"  their builds: {builds}", flush=True)
    for c in (calls, calls_c):
        check_masked_messages(c["tpconv_edge"])
        replay(c, edge_kernels_per_edge(), bitwise=("tpconv_edge",), timed=False)
    per_step = expected_legacy_launches(leg, 1)
    replay({"tpconv_edge": calls["tpconv_edge"][:per_step]}, edge_kernels_per_edge())  # one step's calls, timed
    replay(calls_c, edge_kernels_per_edge())
    del calls, calls_c
    torch.cuda.empty_cache()
    marks.append(("replay", time.perf_counter()))

    # e: confidence training with the affinity heads through the CLI
    score_dir = os.path.join(LEGACY_DIR, "score_lm0")
    checkpoints.save_model_dir(score_dir, ScoreModelConfig(lm_embedding_dim=0),
                               get_model(ScoreModelConfig(lm_embedding_dim=0), device=dev, seed=0))
    csv = os.path.join(LEGACY_DIR, "affinity.csv")
    with open(csv, "w") as f:
        f.write("# complex_name,affinity\n1a0q,6.5\n")
    base = ["--data_dir", data, "--cache_path", os.path.join(LEGACY_DIR, "cache"), "--original_model_dir", score_dir,
            "--limit_complexes", "1", "--inference_steps", str(STEPS), "--samples_per_complex", str(AFF_SAMPLES),
            "--seed", "0"] + device_arg
    with contextlib.redirect_stdout(io.StringIO()):
        confidence_train.main(base + ["--cache_creation_id", "1", "--workdir", os.path.join(LEGACY_DIR, "wd0")])
    # cache id 2: near-crystal poses, since random weights roll out no pose within the cutoff and the affinity
    # column learns only from poses below it ("affinity_valid")
    gen_dir = os.path.join(LEGACY_DIR, "cache", "confidence_generation")
    with open(os.path.join(gen_dir, cdataset.filtering_cache_name("1", AFF_SAMPLES, STEPS, False)), "rb") as f:
        (name,) = pickle.load(f)
    padded_c, hc = host_complex(0)[:2]
    L = len(hc.lig_f)
    crystal = dict(padded_c, lig_pos=padded_c["lig_pos"].copy())
    crystal["lig_pos"][:L] = hc.orig_lig_pos
    near = near_crystal_poses(crystal, CONF_NEAR).numpy()[:, :L]
    near_rmsd = np.sqrt(((near - hc.orig_lig_pos[None]) ** 2).sum(-1).mean(-1))
    with open(os.path.join(gen_dir, cdataset.filtering_cache_name("2", AFF_SAMPLES, STEPS, False)), "wb") as f:
        pickle.dump({name: (near, near_rmsd)}, f)
    print(f"  affinity cache: {AFF_SAMPLES} rollouts of a seeded score model (id 1) and {CONF_NEAR} near-crystal "
          f"poses (id 2; RMSDs {np.round(near_rmsd, 2).tolist()} A)", flush=True)
    runs = (("--parallel 2 (the legacy all-atom model)", "wd_parallel", ["--parallel", "2"]),
            ("--transfer_weights (the residue-level model's affinity column)", "wd_column", ["--transfer_weights"]))
    for what, wd, extra in runs:
        steps = []
        t0 = time.perf_counter()
        with counted_calls(ctrain, "make_confidence_train_step", steps), contextlib.redirect_stdout(text):
            state, hist = confidence_train.main(base + ["--workdir", os.path.join(LEGACY_DIR, wd),
                                                        "--cache_ids", "1,2",
                                                        "--n_epochs", "1", "--batches_per_epoch", str(AFF_BATCHES),
                                                        "--batch_size", str(AFF_BATCH), "--affinity_prediction",
                                                        "--affinity_csv", csv] + extra)
        wall = time.perf_counter() - t0
        m = state.model
        with contextlib.redirect_stdout(io.StringIO()):
            back, back_cfg = load_or_init_model(os.path.join(LEGACY_DIR, wd), "last_model", device=dev)
        same = back_cfg == m.cfg and state_equal(m, back)
        val = hist[0]["val"]
        print(f"  cli.confidence_train --affinity_prediction {what}: {wall:.2f} s; train affinity loss "
              f"{hist[0]['train']['affinity_loss']:.4f}, validation {json.dumps(val)}; the workdir back bit for bit: "
              f"{same}", flush=True)
        want = expected_affinity_train_launches(m)
        steps_line(f"  cli.confidence_train {extra[0]} steps", steps, AFF_BATCH, want)
        if not (same and np.isfinite(val["loss"]) and np.isfinite(val["affinity_rmse"])
                and hist[0]["train"]["affinity_loss"] > 0):
            fail(f"cli.confidence_train --affinity_prediction {what}: not finite, no affinity loss, or the workdir "
                 f"does not load back")
    marks.append(("cli.confidence_train", time.perf_counter()))

    # one step of the affinity model at dropout 0, card against CPU, and its training-kernel calls replayed
    aff_cfg = confidence_model_config(lm_embedding_dim=0, old_score_model=True, affinity_prediction=True, parallel=2,
                                      dropout=0.0, confidence_dropout=0.0, num_conv_layers=AFF_CPU_LAYERS)
    batch = replicate_complex(padded_aa, AFF_CPU_B, device=dev).replace(
        lig_pos=near_crystal_poses(padded_aa, AFF_CPU_B, seed=6).to(dev)).set_time(0.0, 0.0, 0.0)
    labels = dict(y=(np.arange(AFF_CPU_B) % 3 == 0).astype(np.float32),
                  affinity=np.full(AFF_CPU_B, 6.5, np.float32), rmsd=np.ones(AFF_CPU_B, np.float32))
    def make_step(device, dtype=torch.float32):
        model = get_model(aff_cfg, device=device, seed=0).to(dtype)
        model.requires_grad_(True)
        b = batch.map(lambda t: t.to(device, dtype) if t.is_floating_point() else t.to(device))

        def step():
            bc = ctrain._maybe_compact(model, b)
            out = model(bc, deterministic=False, use_running_average=False)
            loss = ctrain._losses(out, ctrain._label_tensors(labels, device), bc.lig_mask, False, 1.0, 0.0, True, True,
                                  1.0, aff_cfg.parallel)[0]
            grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
            return loss, dict(zip([n for n, _ in model.named_parameters()], grads))

        return model, step

    model, step = make_step(dev)  # the card's step once recorded (then the batch statistics put back), then run
    calls = record_train_calls(step)
    for buf, v in get_model(aff_cfg, device=dev, seed=0).named_buffers():
        model.get_buffer(buf).copy_(v)
    (lg, gg), at_relu = relu_units(model, step)
    lc, gc = make_step(cpu)[1]()
    gc = {n: torch.zeros(()) if w is None else w for n, w in gc.items()}
    gg = {n: torch.zeros_like(gc[n]) if g is None else g.cpu() for n, g in gg.items()}
    worst, excused, reading = relu_excused(gg, gc, at_relu, lambda: make_step(cpu, torch.float64)[1]()[1])
    n_excused = len(excused)
    print(f"  affinity model training step B={AFF_CPU_B} (dropout 0) card vs CPU: loss {lg.item():.6f} vs "
          f"{lc.item():.6f}; {len(gc)} gradients, worst error {worst[0]:.3g} of its tolerance ({MODEL_RTOL} x max(1, "
          f"max |cpu|)) at {worst[1]}; off it only at hidden units at the ReLU ({sum(map(len, at_relu.values()))} "
          f"units on the card) where float64 sides with one device: {n_excused} rows (at most 4) {excused}; "
          f"float64 reading {reading}; {len(calls['tpconv_edge'])} edge-list and {len(calls['tpconv_bwd'])} "
          f"backward calls", flush=True)
    if not (abs(lg.item() - lc.item()) <= MODEL_RTOL * max(1.0, abs(lc.item())) and worst[0] <= 1.0
            and n_excused <= 4):
        fail("the affinity model's training step: the card disagrees with the CPU")
    replay_train_kernels(calls, timed=False)
    replay_train_ops(calls, timed=False)
    marks.append(("step card vs CPU", time.perf_counter()))
    print("phase 15 walls: " + ", ".join(f"{name} {t - t_prev:.1f} s" for (_, t_prev), (name, t) in zip(marks, marks[1:]))
          + f"; in all {marks[-1][1] - marks[0][1]:.1f} s", flush=True)


def edge_route_line(mod, K: int) -> str:
    """The edge-list build a layer's launches take for lists of K edges and
    for lists of one edge (the most receivers a block, so the most shared
    memory: if that fits, no list length moves the layer off the build),
    with the shared memory of each (``layout_bytes``); or why it keeps the
    plain TP. Raises where no build fits (``pick_build``), as the layer's
    launch would."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common as tc
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_g import cross_rows_per_block

    if not mod.kernel_harmonics:
        return "plain TP: the kernels do not take these harmonics"
    lay = tc.tp_layout(mod.in_irreps, mod.out_irreps, mod.sh_irreps)
    d = tc.Dims(mod.n_edge_features, 0, mod.n_edge_features, mod.hidden, lay.din, lay.dout)
    parts = [layout_bytes(f"K={k}:", mod, d, cross_rows_per_block(k), mod.edge_build(k)) for k in (K, 1)]
    return "; ".join(parts) + f" (of {tc.SMEM_LIMIT})"


def expected_affinity_train_launches(model) -> dict:
    """Kernel launches of one confidence training step with the affinity
    heads: the legacy all-atom model (every group on the edge-list op, no
    smooth edge weights) or the residue-level model in confidence mode (its
    ligand groups and cross lists on the edge-list op, its receptor kNN
    groups on rec with the dropout mask); one edge backward per op."""
    want = {name: 0 for name in all_counters()}
    if model.cfg.old_score_model:
        edge, rec = expected_legacy_launches(model, 1), 0
    else:
        P, C = len(model.lig_emb_layers), len(model.conv_layers)
        edge, rec = 2 * (P + C) + C + (C - 1), len(model.rec_emb_layers) + C - 1
    want.update(tpconv_edge=edge, tpconv_rec_dm=rec, tpconv_bwd=edge + rec)
    return want


def tc_spills(logs: dict) -> dict:
    """{library: {kernel: bytes of spill stores}} from the ptxas logs, for
    the kernels that run on the tensor cores: those whose weights argument
    is TPWeightsTC (the engine's tensor-core stage) and those TC_KERNELS
    names (the edge backward's per-edge kernel and its two products)."""
    out = {}
    for lib, log in logs.items():
        name = None
        for line in log.splitlines():
            if "Function properties for " in line:
                name = line.split("Function properties for ")[-1].strip()
            elif (name and ("TPWeightsTC" in name or any(k in name for k in TC_KERNELS.get(lib, ())))
                  and "bytes spill stores" in line):
                out.setdefault(lib, {})[name] = int(line.split("bytes spill stores")[0].split(",")[-1])
    return out


def check_tc_spills(spills: dict) -> None:
    """Fails unless every kernel TC_KERNELS names appears, once, in its
    library's ptxas log, and no tensor-core kernel spills."""
    for lib, kernels in TC_KERNELS.items():
        for k in kernels:
            found = [n for n in spills.get(lib, {}) if k in n]
            if len(found) != 1:
                fail(f"{lib}: ptxas reported {len(found)} kernels matching {k}, not 1")
    if any(v for k in spills.values() for v in k.values()):
        fail("every tensor-core kernel must build with no spill")


# ---------------------------------------------------------------------------- phase 16: the score-model remainder


REM_PATHS = {  # the slice's kernel paths: phase 5's score model (seeded, full width) with these fields
    # the all-atom model in score mode, on 1a0q with its seeded atoms; 3 trunk layers hold every layout of the 5-layer
    # trunk (its 74 -> 74 layers with 9 groups and the last layer's 3), which keeps phase 17 within the script's time
    "A": dict(all_atoms=True, sh_lmax=2, num_conv_layers=3),
    "B": dict(sh_lmax=2),  # the residue-level model at lmax=2
    "C": dict(use_second_order_repr=True),  # the second-order irreps ladder at lmax=1: l = 2 node blocks
}
REM_PLAIN = {  # the plain configurations: layers no kernel takes, or a head of their own; the two plain trunks at 3
    # layers (74 -> 74 among them: every layout of phase 5's 5-layer trunk), which keeps phase 17 within the script's time
    "depthwise": dict(depthwise_convolution=True, num_conv_layers=3),
    "tp_weights_layers 3": dict(tp_weights_layers=3, num_conv_layers=3),
    "sidechain": dict(sidechain_pred=True),
}
REM_TIMED = "C"  # the path whose replays are timed: rows 7-12 at l = 2 node blocks
REM_TRAIN_STEPS = 3  # timed training steps a path, after a warm-up
REM_KERNELS = ("tpconv_rec_g", "tpconv_cross_g", "tpconv_edge")  # the general route's inference kernels
REM_CPU_B = 1  # the card-against-CPU forward's batch
REM_TRAIN_B = 16  # TrainConfig().batch_size: the training step's and the plain configurations' forward batch


def expected_remainder_launches(model, steps: int) -> dict:
    """Kernel launches of one shared-receptor sample of a general-route model
    (the JAX package's routing for layouts off the lmax=1 ladder): the
    receptor embedding once, then per step: the residue-level model's ligand
    pairs (embedding and trunk) on the edge-list kernel (sums; their bonds
    take the plain TP), per trunk layer the ligand <- receptor lists on
    cross_g and, but for the last, the receptor kNN group on rec_g and the
    receptor <- ligand lists on the edge-list kernel (per edge); the all-atom
    model's residue and atom kNN groups on rec_g and its two ligand cross
    groups on cross_g (every other group takes the plain TP). No ladder
    kernel. On the "edge" route (sh_lmax=3) the rec_g and cross_g groups
    gather their senders and run the edge-list kernel instead."""
    want = {name: 0 for name in all_counters()}
    P, C = len(model.rec_emb_layers), len(model.conv_layers)
    if model.cfg.all_atoms:
        want.update(tpconv_rec_g=2 * P + 2 * (C - 1) * steps, tpconv_cross_g=2 * C * steps)
    else:
        want.update(tpconv_rec_g=P + (C - 1) * steps, tpconv_cross_g=C * steps,
                    tpconv_edge=(len(model.lig_emb_layers) + 2 * C - 1) * steps)
    if model.conv_layers[0].route == "edge":
        want["tpconv_edge"] += want["tpconv_rec_g"] + want["tpconv_cross_g"]
        want.update(tpconv_rec_g=0, tpconv_cross_g=0)
    return want


def expected_remainder_train_launches(model) -> dict:
    """Kernel launches of one training step of a score model off the ladder
    route: phase 7's (``expected_train_launches``) or phase 12's
    (``expected_conf_train_launches``) groups with rec_g's masked variant for
    the kNN groups, plus the center convolution and, where its harmonics
    take a kernel, the torsion convolution on the edge-list kernel; layers on
    no kernel route (``TPConv.route`` None) launch nothing. On the "edge"
    route (sh_lmax=3) the kNN groups gather their senders and run the
    differentiable edge-list op."""
    want = {name: 0 for name in all_counters()}
    routed = lambda mod: mod is not None and mod.route is not None  # noqa: E731
    heads = int(routed(getattr(model, "final_conv", None))) + int(routed(getattr(model, "tor_bond_conv", None)))
    P, C = len(model.rec_emb_layers), len(model.conv_layers)
    if not routed(model.conv_layers[0]):
        edge, rec = 0, 0
    elif model.cfg.all_atoms:
        conf = expected_conf_train_launches(model)
        edge, rec = conf["tpconv_edge"], conf["tpconv_rec_g_dm"]
    else:
        edge = 2 * (len(model.lig_emb_layers) + C) + C + (C - 1)
        rec = P + C - 1
    kind = "tpconv_rec_dm" if model.conv_layers[0].ladder else "tpconv_rec_g_dm"
    if model.conv_layers[0].route == "edge":
        edge, rec = edge + rec, 0
    want.update(tpconv_edge=edge + heads, tpconv_bwd=edge + heads + rec, **{kind: rec})
    return want


def layout_bytes(what: str, mod, d, rt: int, tc_cm: tuple) -> str:
    """A layer's build of one kernel (``pick_build``'s choice) and its shared
    memory, dynamic and static, as the host mirror counts it."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common as tc

    on_tc, cm = tc_cm
    shd = tc.sh_dim(mod.sh_irreps)
    if on_tc:
        lay = tc.tp_layout(mod.in_irreps, mod.out_irreps, mod.sh_irreps, tc.TNC)
        b = tc.engine_smem_bytes(shd, tc.TM, d, lay.n_x, rt, True, len(lay.cg), len(lay.epi), lay.n_tiles)
    else:
        b = tc.engine_smem_bytes(shd, cm, d, tc.tp_layout(mod.in_irreps, mod.out_irreps, mod.sh_irreps).n_x, rt)
    b += tc.engine_static_bytes(tc.TM if on_tc else cm, on_tc)
    return f"{what} {'tensor cores' if on_tc else f'float32 at {cm} edges a chunk'}, {b} bytes"


def layer_builds(model, K_cross: int, K_edge: int) -> list:
    """One line per TP-conv layer of ``model``: its route and, on a kernel
    route, the build and shared-memory bytes of rec_g (with and without the
    dropout mask) and cross_g at K_cross senders a receiver where the layer
    takes them (the general route), and the edge-list kernel at K_edge edges
    a row (``pick_build`` raises where none fits, as the launch would)."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_common as tc, tpconv_edge, tpconv_g
    from confidence_bootstrapping_tpu_torch.ops.irreps import Irreps

    lines = []
    for name, mod in model.named_modules():
        if not isinstance(mod, TPConv):
            continue
        shd = tc.sh_dim(mod.sh_irreps) if mod.kernel_harmonics else "up to l=4"
        head = f"{name}: {Irreps(mod.in_irreps).dim} -> {Irreps(mod.out_irreps).dim}, harmonics {shd}"
        if mod.route is None:
            lines.append(f"{head}: plain ({'depthwise' if mod.depthwise else 'no kernel route'})")
            continue
        lay = tc.tp_layout(mod.in_irreps, mod.out_irreps, mod.sh_irreps)
        F, H, ns = mod.n_edge_features, mod.hidden, model.cfg.ns
        parts = [f"route {mod.route}"]
        if mod.route == "general" and F == 3 * ns and not name.startswith("tor_bond_conv"):
            d = tc.Dims(ns, ns, F, H, lay.din, lay.dout)
            for dm in (False, True):
                parts.append(layout_bytes("rec_g" + (" with the mask" if dm else ""), mod, d, tpconv_g.RT_REC,
                                          tpconv_g.rec_g_build(mod.in_irreps, mod.sh_irreps, mod.out_irreps, ns, ns,
                                                               H, dm)))
            parts.append(layout_bytes(f"cross_g K={K_cross}", mod, d, tpconv_g.cross_rows_per_block(K_cross),
                                      tpconv_g.cross_build("tpconv_cross_g", mod.in_irreps, mod.out_irreps,
                                                           mod.sh_irreps, ns, ns, H, K_cross)))
        d = tc.Dims(F, 0, F, H, lay.din, lay.dout)
        parts.append(layout_bytes(f"edge K={K_edge}", mod, d, tpconv_g.cross_rows_per_block(K_edge),
                                  tpconv_edge.edge_build(mod.in_irreps, mod.sh_irreps, mod.out_irreps, F, H, K_edge)))
        lines.append(f"{head}: " + ", ".join(parts))
    return lines


def remainder_kernels() -> dict:
    """The general route's inference kernels with their plain versions, work
    and the TPU kernels they replace, as ``replay`` takes them; the
    edge-list kernel's calls carry (dmask, sum_k) at the end of their
    arguments (``edge_calls``)."""
    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge, tpconv_g

    return {
        "tpconv_rec_g": (tpconv_g.fused_tpconv_rec_g, tpconv_g.tpconv_rec_g_plain, rec_work,
                         "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:457"),
        "tpconv_cross_g": (tpconv_g.fused_tpconv_cross_g, tpconv_g.tpconv_cross_g_plain, cross_g_work,
                           "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:547"),
        "tpconv_edge": (lambda *a, **kw: tpconv_edge.fused_tpconv_edge(*a[:11], dmask=a[11], sum_k=a[12], **kw),
                        tpconv_edge.tpconv_edge_plain, edge_work, "confidence_bootstrapping_tpu/ops/pallas/tpconv_g.py:303"),
    }


def edge_calls(calls: dict) -> dict:
    """Recorded calls with the edge-list kernel's ``sum_k`` moved into its
    arguments (after a None dropout mask), the order its plain version takes."""
    out = dict(calls)
    out["tpconv_edge"] = [(a + (None, kw.get("sum_k", True)), {"packed": kw.get("packed")})
                          for a, kw in calls["tpconv_edge"]]
    return out


def counted_all(run) -> tuple:
    """(run()'s result, every kernel counter's launches in it, the plain
    versions' calls in it): counts set to 0 just before, read just after,
    synchronised. The plain versions run only for CPU tensors, so on the card
    any call would be a plain TP on a kernel route."""
    import torch

    from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_edge, tpconv_g

    plains = {"tpconv_rec_g_plain": tpconv_g, "tpconv_cross_g_plain": tpconv_g, "tpconv_edge_plain": tpconv_edge}
    seen = {name: 0 for name in plains}
    orig = {name: getattr(mod, name) for name, mod in plains.items()}

    def counting(name):
        def call(*a, **kw):
            seen[name] += 1
            return orig[name](*a, **kw)
        return call

    for fn, attr in all_counters().values():
        setattr(fn, attr, 0)
    try:
        for name, mod in plains.items():
            setattr(mod, name, counting(name))
        out = run()
        torch.cuda.synchronize()
    finally:
        for name, mod in plains.items():
            setattr(mod, name, orig[name])
    return out, read_counters(), seen


def card_vs_cpu_forward(dev, cfg, padded, what: str) -> None:
    """The model of ``cfg`` (seed 0) at B=REM_CPU_B on poses near the crystal
    pose: the card against the CPU, per output within MODEL_RTOL."""
    import torch

    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model

    poses = near_crystal_poses(padded, REM_CPU_B)
    outs = []
    for device in (dev, torch.device("cpu")):
        model = get_model(cfg, device=device, seed=0)
        batch = replicate_complex(padded, REM_CPU_B, device=device).replace(lig_pos=poses.to(device))
        with torch.no_grad():
            outs.append([None if t is None else t.cpu() for t in model(batch.set_time(0.5, 0.5, 0.5))])
    for name, g, w in zip(("tr_pred", "rot_pred", "tor_pred", "sidechain_pred"), *outs):
        if w is None:
            continue
        err, peak = (g - w).abs().max().item(), w.abs().max().item()
        print(f"{what}: forward card vs CPU at B={REM_CPU_B}, {name}: max_abs_err {err:.3g} (max |cpu| {peak:.3g}, "
              f"tolerance {MODEL_RTOL} x max(1, max |cpu|))", flush=True)
        if not (err <= MODEL_RTOL * max(1.0, peak) and torch.isfinite(g).all()):
            fail(f"{what}: the card disagrees with the CPU ({name})")


def remainder_train(model, batch, what: str, timed: bool, require_tc: bool = False) -> tuple:
    """One path's training: a warm-up and REM_TRAIN_STEPS timed
    ``TrainConfig()`` steps (median ms, launches per step against the
    config), then one step's kernel calls recorded and replayed through
    kernel and plain version (timed with ``timed``; with ``require_tc``
    every edge-list call on a tensor-core build). -> (median ms, the JSON
    rows, the launches of a step)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import TrainConfig
    from confidence_bootstrapping_tpu_torch.train import train_loop

    tcfg = TrainConfig()
    state = train_loop.init_train_state(model, tcfg)
    step = train_loop.make_train_step(model.cfg, tcfg)
    gen = torch.Generator(device=batch.lig_pos.device).manual_seed(13)
    step(state, batch, gen)  # warm-up
    walls, launches, losses = [], [], []
    for _ in range(REM_TRAIN_STEPS):
        t0 = time.perf_counter()
        (metrics, counts, plain) = counted_all(lambda: step(state, batch, gen))
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(counts)
        losses.append(metrics["loss"].item())
        if any(plain.values()):
            fail(f"{what}: a training step ran a plain TP on a kernel route ({plain})")
    want = expected_remainder_train_launches(model)
    med = float(np.median(walls))
    print(f"{what}: training step (B={batch.batch_size}, TrainConfig(), dropout {model.cfg.dropout}) median {med:.2f} "
          f"ms over {REM_TRAIN_STEPS} ({', '.join(f'{w:.1f}' for w in walls)}), {batch.batch_size / med * 1e3:.3f} "
          f"training poses/s; losses {', '.join(f'{v:.4f}' for v in losses)}; launches a step "
          f"{nonzero(launches[-1])}, expected from the config {nonzero(want)}", flush=True)
    if any(n != want for n in launches) or not all(np.isfinite(losses)):
        fail(f"{what}: a training step's launches differ from the config's, or its loss is not finite")
    if not any(want.values()):
        return med, [], launches[-1]
    calls = record_train_calls(lambda: step(state, batch, gen))
    torch.cuda.synchronize()
    print(f"{what}: training builds {edge_builds(calls)}; backward builds {bwd_builds(calls)}", flush=True)
    if require_tc:
        check_tc_builds({"tpconv_edge": calls["tpconv_edge"]}, f"{what}: training step")
    rows = replay_train_kernels(calls, timed=timed)
    rows += replay_train_ops(calls, timed=timed)
    return med, rows, launches[-1]


def remainder_path(dev, path: str, fields: dict, conf, timed: bool, require_tc: bool = False) -> tuple:
    """One kernel path: phase 5's score model with ``fields`` (``REM_PATHS``,
    ``SH3_PATHS``): the layers' builds and bytes, a B=1 forward card against
    CPU, the B=32 20-step sample (timed, after a warm-up with ``timed``:
    poses/s; launches against the config; no plain version called), its poses reranked by
    phase 6's confidence model (timed; the all-atom model also with
    ``embed_full_receptor``), every kernel call of one sample replayed
    through kernel and plain version (bit for bit across two launches,
    masked per-edge messages exactly zero; timed with ``timed``; with
    ``require_tc`` every edge-list call on a tensor-core build), then the
    B=16 training step (``remainder_train``). -> (the JSON rows of the
    kernels with their launches per sample (inference) or per step
    (training) when ``timed``, else [], and the sample's final poses)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler.sampling import randomize_position, score_confidence

    conf_model, conf_batch = conf[0], conf[1]
    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM, **fields)
    what = f"path {path} ({', '.join(f'{k}={v}' for k, v in fields.items())})"
    padded = host_complex(LM_DIM, all_atoms=cfg.all_atoms)[0]
    model = get_model(cfg, device=dev, seed=0)
    K = cfg.effective_cross_cap(padded["rec_pos"].shape[0])
    print(f"{what}: ns={cfg.ns} nv={cfg.nv}, {cfg.num_prot_emb_layers} embedding and {cfg.num_conv_layers} trunk "
          f"layers, lm_dim {LM_DIM}; 1a0q N={padded['rec_pos'].shape[0]}"
          + (f" A={padded['atom_pos'].shape[0]}" if cfg.all_atoms else "") + f", cross cap {K}; layers by route:",
          flush=True)
    for line in layer_builds(model, K, padded["lig_pos"].shape[0]):
        print(f"  {line}", flush=True)
    card_vs_cpu_forward(dev, cfg, padded, what)

    batch = replicate_complex(padded, B_POSES, device=dev)
    b0 = randomize_position(batch, torch.Generator(device=dev).manual_seed(0), cfg.sigma.tr_sigma_max)
    run, plan = sample_run(model, b0)
    warm = "no warm-up (untimed path: the first run)"
    if timed:
        t0 = time.perf_counter()
        run()  # warm-up
        torch.cuda.synchronize()
        warm = f"warm-up {time.perf_counter() - t0:.3f} s"
    t0 = time.perf_counter()
    (final, _), launches, plain = counted_all(run)
    secs = time.perf_counter() - t0
    moved = (final.lig_pos - b0.lig_pos)[b0.lig_mask].norm(dim=-1).mean().item()
    want = expected_remainder_launches(model, STEPS)
    print(f"{what}: sample B={B_POSES}, {STEPS} steps, plan {plan if not cfg.all_atoms else 'none (all-atom)'}: {warm}, "
          f"timed {secs:.4f} s, {B_POSES / secs:.3f} poses/s; mean atom displacement {moved:.3g} A; "
          f"launches {nonzero(launches)}, expected from the config {nonzero(want)}; plain versions called {plain}",
          flush=True)
    if launches != want or any(plain.values()):
        fail(f"{what}: the sample did not run every TP-conv of a kernel route through its kernel")
    if not (torch.isfinite(final.lig_pos).all() and moved > 0.1):
        fail(f"{what}: final poses are not finite or did not move")

    rerank = lambda full=False: score_confidence(conf_model, conf_batch, lig_pos=final.lig_pos,  # noqa: E731
                                                 embed_full_receptor=full)
    for full in ((False, True) if cfg.all_atoms else (False,)):
        rerank(full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = rerank(full)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{what}: rerank of the {B_POSES} poses by phase 6's model{' (embed_full_receptor)' if full else ''}: "
              f"{ms:.1f} ms; confidences {c.min().item():.4f} to {c.max().item():.4f}", flush=True)
        if not torch.isfinite(c).all():
            fail(f"{what}: the rerank's confidences are not finite")

    raw = record_calls(run, REM_KERNELS)
    calls = edge_calls(raw)
    torch.cuda.synchronize()
    if require_tc:
        check_tc_builds({"tpconv_edge": calls["tpconv_edge"]}, f"{what}: inference")
    else:
        print(f"{what}: inference builds {edge_builds(calls)}", flush=True)
    check_masked_messages([c for c in raw["tpconv_edge"] if not c[1].get("sum_k", True)])
    with torch.no_grad():
        rows = replay(calls, {k: v for k, v in remainder_kernels().items() if calls[k]}, bitwise=REM_KERNELS,
                      timed=timed)
    del calls, raw
    torch.cuda.empty_cache()
    tbatch = replicate_complex(padded, REM_TRAIN_B, device=dev)
    model.requires_grad_(True)
    train_ms, train_rows, train_launches = remainder_train(model, tbatch, what, timed, require_tc)
    print(f"{what}: {B_POSES / secs:.3f} poses/s, rerank above, training step {train_ms:.2f} ms", flush=True)
    if not timed:
        return [], final.lig_pos
    ops = {"fused_tpconv_train": "tpconv_edge", "fused_tpconv_rec_train": "tpconv_rec_g_dm"}  # an op's launches: its forward's
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["name"] += f", path {path}"
    for r in train_rows:
        r["launches"] = train_launches[ops.get(r["name"], r["name"])]
        r["name"] += f", path {path} training"
    return rows + train_rows, final.lig_pos


def remainder_plain(dev, name: str) -> None:
    """A plain configuration (``REM_PLAIN``) at phase 5's widths: its layers'
    routes, a B=1 forward card against CPU, one B=16 forward (launches:
    phase 5's kernels where the trunk keeps the ladder route, none where its
    layers are plain) and one training step (``remainder_train``)."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.factory import get_model

    cfg = ScoreModelConfig(lm_embedding_dim=LM_DIM, **REM_PLAIN[name])
    what = f"plain configuration {name}"
    padded = host_complex(LM_DIM)[0]
    model = get_model(cfg, device=dev, seed=0)
    routes = {str(layer.route) for layer in model.conv_layers}
    print(f"{what}: trunk routes {routes}", flush=True)
    card_vs_cpu_forward(dev, cfg, padded, what)
    batch = replicate_complex(padded, REM_TRAIN_B, device=dev).replace(
        lig_pos=near_crystal_poses(padded, REM_TRAIN_B).to(dev)).set_time(0.5, 0.5, 0.5)
    with torch.no_grad():
        out, launches, plain = counted_all(lambda: model(batch))
    want = {k: 0 for k in launches}
    if model.conv_layers[0].ladder:
        want.update(expected_launches(model, 1))
    print(f"{what}: forward B={REM_TRAIN_B} launches {nonzero(launches)}, expected {nonzero(want)}", flush=True)
    if launches != want or any(plain.values()) or not all(torch.isfinite(t).all() for t in out if t is not None):
        fail(f"{what}: the forward's launches differ from the config's, or an output is not finite")
    if cfg.sidechain_pred and tuple(out.sidechain_pred.shape) != (REM_TRAIN_B, padded["rec_pos"].shape[0], 10):
        fail(f"{what}: the side-chain head's output has the wrong shape")
    model.requires_grad_(True)
    remainder_train(model, replicate_complex(padded, REM_TRAIN_B, device=dev), what, timed=False)


def remainder_phase(dev, conf, card: str) -> tuple:
    """Phase 16 (see the module docstring); every line ends with the card's
    name and power limit. -> the JSON rows of the timed path's kernels."""
    import torch

    t0 = time.perf_counter()
    stdout = sys.stdout
    sys.stdout = Tagged(stdout, card)
    try:
        rows = []
        for path, fields in REM_PATHS.items():
            rows += remainder_path(dev, path, fields, conf, timed=path == REM_TIMED)[0]
            torch.cuda.empty_cache()
        for name in REM_PLAIN:
            remainder_plain(dev, name)
            torch.cuda.empty_cache()
        print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        sys.stdout.flush()
        sys.stdout = stdout
    return rows


# ---------------------------------------------------------------------------- phase 17: sh_lmax = 3


SH3_PATHS = {  # phase 5's score model (seeded, full width) with these fields; 16-wide harmonics
    "D": dict(sh_lmax=3, no_torsion=True),
    "F": dict(use_second_order_repr=True, sh_lmax=3, no_torsion=True),  # the float32 and 5-wide SHD=16 builds
}


def sh3_refusal() -> None:
    """The torsion head at sh_lmax = 3 (phase 5's config with sh_lmax 3):
    the factory must refuse it, naming the JAX package's KeyError: 5."""
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
    from confidence_bootstrapping_tpu_torch.models.factory import get_model

    try:
        get_model(ScoreModelConfig(lm_embedding_dim=LM_DIM, sh_lmax=3), device="cpu")
    except ValueError as e:
        print(f"the torsion head at sh_lmax=3 refused: {e}", flush=True)
        if "KeyError: 5" not in str(e):
            fail("the torsion head's refusal at sh_lmax=3 does not name the JAX package's failure")
        return
    fail("the score model with its torsion head at sh_lmax=3 was not refused")


def sh3_confidence(dev, poses) -> None:
    """(E): phase 6's confidence architecture at sh_lmax=3 (seed 0; 1a0q's
    crystal pose and 3183 seeded atoms): the layers' builds and the rerank
    of (D)'s poses through ``rerank_check`` (untimed replays)."""
    from confidence_bootstrapping_tpu_torch.config import confidence_model_config
    from confidence_bootstrapping_tpu_torch.models.factory import get_model

    cfg = confidence_model_config(lm_embedding_dim=LM_DIM, sh_lmax=3)
    what = "(E) the confidence model at sh_lmax=3"
    padded, hc, _ = host_complex(LM_DIM, all_atoms=True)
    padded["lig_pos"][: len(hc.orig_lig_pos)] = hc.orig_lig_pos  # the crystal pose
    model = get_model(cfg, device=dev, seed=0)
    print(f"{what}: ns={cfg.ns} nv={cfg.nv}, {cfg.num_conv_layers} trunk layers, lm_dim {LM_DIM}; layers by route:",
          flush=True)
    for line in layer_builds(model, 0, padded["lig_pos"].shape[0]):
        print(f"  {line}", flush=True)
    rerank_check(model, padded, poses, f"{what}: (D)'s poses", timed=False)


def sh3_phase(dev, conf, card: str) -> list:
    """Phase 17 (see the module docstring); every line ends with the card's
    name and power limit. -> the JSON rows of (D)'s 16-wide kernels (rows 7,
    10 and 11), launches per sample (inference) or per training step."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig

    t0 = time.perf_counter()
    stdout = sys.stdout
    sys.stdout = Tagged(stdout, card)
    try:
        sh3_refusal()
        padded = host_complex(LM_DIM)[0]
        rows, poses = remainder_path(dev, "D", SH3_PATHS["D"], conf, timed=True, require_tc=True)
        for r in rows:
            r["name"] = r["name"].replace("path D", "sh_lmax=3 (D)")
        torch.cuda.empty_cache()
        step_card_vs_cpu(dev, ScoreModelConfig(lm_embedding_dim=LM_DIM, dropout=0.0, **SH3_PATHS["D"]), padded,
                         "(D) training step")
        sh3_confidence(dev, poses)
        torch.cuda.empty_cache()
        remainder_path(dev, "F", SH3_PATHS["F"], conf, timed=False)
        torch.cuda.empty_cache()
        step_card_vs_cpu(dev, ScoreModelConfig(lm_embedding_dim=LM_DIM, dropout=0.0, **SH3_PATHS["F"]), padded,
                         "(F) training step")
        print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        sys.stdout.flush()
        sys.stdout = stdout
    return rows


# ---------------------------------------------------------------------------- phase 18: data parallel

DP_DIR = os.path.join(ROOT, "build", "dp")  # 1a0q as files, a model directory, the ranks' store and results; removed
DP_RANKS = 2  # (H) and (I): ranks on cuda:0 over gloo (NCCL refuses two ranks on one card)
DP_TIMEOUT = 600  # s: the ranks' wall limit
DP_CHILD = [sys.executable, os.path.abspath(__file__), "--dp-rank"]  # + rank, directory, device
DP_INFER_SAMPLES = 8  # (G): poses of 1a0q in each evaluator run
RMSDS_ATOL = 1e-4  # (G): rmsds.npy with --data_parallel against the run without, in A
LOSS_RTOL, PARAM_ATOL = 1e-4, 2.5e-3  # tests/test_training.py:150-155 argues the parameters' bound
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4  # elementwise, tests/test_torch_training.py's bar for whole-model gradients


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_infer_nccl(model) -> None:
    """(G): ``cli.infer`` on 1a0q from files (phase 13's set-up) without the
    flag, then with ``--data_parallel`` at world size 1 over NCCL in this
    process (torchrun's environment); rmsds.npy alike within RMSDS_ATOL or
    twice the run without the flag's own spread over reruns
    (``rerun_tolerance``), whichever is larger."""
    import contextlib
    import io
    import shutil

    import torch
    import torch.distributed as dist

    from confidence_bootstrapping_tpu_torch.cli import infer
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    prot, lig, esm = write_1a0q(os.path.join(DP_DIR, "inputs"))[:3]
    data = os.path.join(DP_DIR, "data", "1a0q")
    os.makedirs(data)
    for src in (prot, lig):
        shutil.copy(src, os.path.join(data, os.path.basename(src)))
    torch.save({"1a0q": torch.load(esm)["A"].numpy()}, os.path.join(DP_DIR, "esm.pt"))
    checkpoints.save_model_dir(os.path.join(DP_DIR, "score"), model.cfg, model)
    argv = ["--data_dir", os.path.dirname(data), "--samples_per_complex", str(DP_INFER_SAMPLES), "--inference_steps",
            str(STEPS), "--model_dir", os.path.join(DP_DIR, "score"), "--esm_embeddings_path",
            os.path.join(DP_DIR, "esm.pt"), "--cache_path", os.path.join(DP_DIR, "cache")]
    walls, world, n = {}, None, [0]

    def run(tag, extra=()):
        """One ``cli.infer`` call into DP_DIR/tag -> its rmsds.npy."""
        nonlocal world
        env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(free_port())) if extra else {}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                m = infer.main(argv + ["--out_dir", os.path.join(DP_DIR, tag)] + list(extra))
            torch.cuda.synchronize()
            walls[tag] = time.perf_counter() - t0
            if extra:
                world = (dist.get_backend(), dist.get_world_size())
                dist.destroy_process_group()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if m["failures"]:
            fail(f"(G) infer {tag}: {m['failures']} failures")
        return np.load(os.path.join(DP_DIR, tag, "rmsds.npy"))

    def again():
        n[0] += 1
        return run(f"again{n[0]}")

    one = run("one")
    tol = rerun_tolerance(again, one, RMSDS_ATOL, "(G)'s cli.infer without the flag")
    err = float(np.abs(one - run("nccl", ["--data_parallel"])).max())
    print(f"(G) cli.infer --data_parallel on 1a0q ({DP_INFER_SAMPLES} poses x {STEPS} steps) in this process over "
          f"{world[0]} at world size {world[1]}: {walls['nccl']:.3f} s (without the flag {walls['one']:.3f} s); "
          f"rmsds.npy max_abs_err {err:.3g} A (tolerance {tol:.3g} A)", flush=True)
    if world != ("nccl", 1) or not err <= tol:
        fail("(G): --data_parallel over NCCL at world size 1 does not give the run without it")


def dp_step(dev, mesh=None, dropout: float = 0.0, cut: bool = False) -> dict:
    """One ``TrainConfig()`` step (lr 1e-3, Adam) of phase 7's score model
    (seed 0, full width) on 1a0q x 16 at ``dropout``, its noise from seed 11:
    over ``mesh`` (8 poses a rank; ``cut``: the state cut over the model axis
    by ``shard_model_tree``) or in one process. -> the loss, the gradients
    the update took (reduced over the ranks), the parameters and batch
    statistics after it, the step's wall, its gradient all-reduce ms and
    its launches."""
    import torch

    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, TrainConfig
    from confidence_bootstrapping_tpu_torch.data.complex_graph import replicate_complex
    from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
    from confidence_bootstrapping_tpu_torch.parallel import mesh as meshlib
    from confidence_bootstrapping_tpu_torch.train import train_loop

    cfg, tcfg = ScoreModelConfig(lm_embedding_dim=LM_DIM, dropout=dropout), TrainConfig()
    model = TensorProductScoreModel(cfg, device=dev, seed=0)
    state = train_loop.init_train_state(model, tcfg)
    if cut:
        state = meshlib.shard_model_tree(mesh, state)
    batch = replicate_complex(host_complex(LM_DIM)[0], tcfg.batch_size, device=dev)
    grads, reduce_s = [], []
    real_apply, real_reduce = train_loop.apply_gradients, meshlib.reduce_gradients

    def apply(st, g, *a, **k):
        grads.append([torch.zeros(p.shape) if x is None else x.detach().cpu() for x, p in zip(g, model.parameters())])
        return real_apply(st, g, *a, **k)

    def reduce(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_reduce(*a, **k)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t)
        return out

    counters = train_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    train_loop.apply_gradients, meshlib.reduce_gradients = apply, reduce
    try:
        t0 = time.perf_counter()
        m = train_loop.make_train_step(cfg, tcfg, mesh)(state, batch, torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_loop.apply_gradients, meshlib.reduce_gradients = real_apply, real_reduce
    names = [n for n, _ in model.named_parameters()]
    return dict(loss=float(m["loss"]), skipped=float(m["skipped"]), grads=dict(zip(names, grads[0])),
                params={n: p.detach().cpu() for n, p in model.named_parameters()},
                buffers={n: b.cpu() for n, b in model.named_buffers()}, wall=wall, reduce_ms=1e3 * sum(reduce_s),
                rows=batch.batch_size // (mesh.shape["data"] if mesh is not None else 1),
                launches={name: getattr(fn, attr) for name, (fn, attr) in counters.items()}, n_cut=len(state.shards),
                want=expected_train_launches(model))


def gloo_gather_probe(dev) -> str:
    """Whether gloo's all_gather takes tensors on ``dev`` as they are
    (``parallel/mesh`` stages CUDA tensors through host memory either way)."""
    import torch
    import torch.distributed as dist

    x = torch.ones(2, device=dev)
    try:
        dist.all_gather([torch.empty_like(x) for _ in range(DP_RANKS)], x)
        return "takes them"
    except (RuntimeError, ValueError) as e:
        return f"refuses them ({str(e).strip().splitlines()[0][:120]})"


def dp_rank(rank: int, d: str, device: str) -> None:
    """One rank of (H) and (I), spawned by ``dp_phase``: it loads the
    kernels the parent built (and fails rather than build them), joins a
    gloo group of DP_RANKS on ``device`` through a file store in ``d``, runs the
    steps at dropout 0 and 0.1 and the timed B=32 sample over a 1-D mesh,
    then the step on the (1, DP_RANKS) data x model mesh, and saves what it
    measured to ``d/rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import confidence_bootstrapping_tpu_torch  # noqa: F401  (switches TF32 off)
    from confidence_bootstrapping_tpu_torch.ops.cuda import build
    from confidence_bootstrapping_tpu_torch.parallel import mesh as meshlib

    if build.stale():
        fail(f"rank {rank}: {build.stale()} not built: a rank loads the parent's build and never builds")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}", world_size=DP_RANKS, rank=rank)
    mesh = meshlib.make_mesh(device=dev)
    out = {"gather": gloo_gather_probe(dev)}
    out.update(step0=dp_step(dev, mesh), step01=dp_step(dev, mesh, dropout=0.1))
    model, b0, _ = main_path(dev)
    run = sample_run(model, b0, mesh)[0]
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    (final, _), launches = counted(run)
    out["sample"] = dict(pos=final.lig_pos.cpu(), warm=warm, secs=time.perf_counter() - t0, launches=launches,
                         want=expected_launches(model, STEPS))
    del model
    torch.cuda.empty_cache()
    out["step2d"] = dp_step(dev, meshlib.make_mesh_2d(1, DP_RANKS, device=dev), cut=True)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.destroy_process_group()


def worst(got: dict, want: dict, floor: float) -> tuple:
    """(the largest max |got - want| / max(floor, max |want|) over the
    tensors, its name)."""
    return max(((got[n] - w).abs().max().item() / max(floor, w.abs().max().item()), n) for n, w in want.items()
               if w.numel())


def dp_check(what: str, got: dict, ref: dict) -> None:
    """A rank's step against the one-process step: loss within LOSS_RTOL,
    every gradient element within GRAD_ATOL + GRAD_RTOL x |its value|, each
    parameter within PARAM_ATOL, the batch statistics within MODEL_RTOL x
    max(1, max |value|). Printed beside the gradients' bound: their worst
    error relative to each tensor's max |value|."""
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    g = max((((got["grads"][n] - w).abs() / (GRAD_ATOL + GRAD_RTOL * w.abs())).max().item(), n)
            for n, w in ref["grads"].items() if w.numel())
    g_max = worst(got["grads"], ref["grads"], 1e-12)
    p = worst(got["params"], ref["params"], 1.0)
    b = worst(got["buffers"], ref["buffers"], 1.0)
    print(f"{what}: loss {got['loss']:.6f} vs {ref['loss']:.6f} (rel {loss_err:.3g}, tolerance {LOSS_RTOL}); "
          f"gradients worst {g[0]:.3g} of their tolerance ({GRAD_ATOL} + {GRAD_RTOL} x |value|) at {g[1]}, "
          f"{g_max[0]:.3g} of the tensor's max |value| at {g_max[1]}; parameters after the step max_abs_err "
          f"{p[0]:.3g} (tolerance {PARAM_ATOL}) at {p[1]}; batch statistics {b[0]:.3g} (tolerance {MODEL_RTOL})",
          flush=True)
    if not (loss_err <= LOSS_RTOL and g[0] <= 1.0 and p[0] <= PARAM_ATOL and b[0] <= MODEL_RTOL
            and got["skipped"] == 0.0):
        fail(f"{what} does not equal the one-process step")


def dp_phase(dev, b0, final_pos, model, poses_s: float, card: str, pos_tol: float) -> None:
    """Phase 18 (see the module docstring); every line ends with the card's
    name and power limit. ``b0``/``final_pos``: phase 5's prior and poses;
    ``model``: phase 5's score model; ``poses_s``: phase 5's rate;
    ``pos_tol``: ``sample_tolerance``."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    stdout = sys.stdout
    sys.stdout = Tagged(stdout, card)
    try:
        shutil.rmtree(DP_DIR, ignore_errors=True)
        os.makedirs(DP_DIR)
        t0 = time.perf_counter()
        dp_infer_nccl(model)
        t_g = time.perf_counter() - t0

        t0 = time.perf_counter()
        ref0, ref01 = dp_step(dev), dp_step(dev, dropout=0.1)
        logs = [open(os.path.join(DP_DIR, f"rank{r}.log"), "w") for r in range(DP_RANKS)]
        device = str(torch.device(dev.type, 0) if dev.index is None else dev)  # the ranks share phase 5's card
        procs = [subprocess.Popen(DP_CHILD + [str(r), DP_DIR, device], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(DP_RANKS)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        t_ranks = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                print(open(os.path.join(DP_DIR, f"rank{r}.log")).read()[-6000:], flush=True)
                fail(f"rank {r} of (H)/(I) exited {p.returncode}")
        outs = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"), weights_only=False) for r in range(DP_RANKS)]

        mask = b0.lig_mask.cpu()
        for r, o in enumerate(outs):
            s0, s01, smp, s2 = o["step0"], o["step01"], o["sample"], o["step2d"]
            print(f"(H) rank {r} of {DP_RANKS} on {device} over gloo: step at dropout 0, {s0['rows']} of {ref0['rows']} "
                  f"poses: {s0['wall']:.3f} "
                  f"s (the rank's first; one process {ref0['wall']:.3f} s), gradient all-reduce {s0['reduce_ms']:.2f} "
                  f"ms; launches {s0['launches']} (one process {ref0['launches']})", flush=True)
            dp_check(f"(H) rank {r}, step at dropout 0 against one process", s0, ref0)
            if s0["launches"] != ref0["launches"]:
                fail("(H): a rank's step launches what one process's does not")
            d01 = abs(s01["loss"] - ref01["loss"]) / abs(ref01["loss"])
            p01 = worst(s01["params"], ref01["params"], 1.0)
            print(f"(H) rank {r}, step at dropout 0.1: loss {s01['loss']:.6f} (one process {ref01['loss']:.6f}, rel "
                  f"{d01:.3g}; masks drawn at the global rows), parameters max_abs_err {p01[0]:.3g}; {s01['wall']:.3f} s, "
                  f"all-reduce {s01['reduce_ms']:.2f} ms; launches {s01['launches']}, expected from the config "
                  f"{s01['want']}", flush=True)
            if not np.isfinite(s01["loss"]) or s01["skipped"] or s01["launches"] != s01["want"]:
                fail("(H): the step at dropout 0.1 is not finite or misses a kernel")
            err = float((smp["pos"] - final_pos.cpu())[mask].abs().max())
            print(f"(H) rank {r}, phase 5's sample over the ranks (B={B_POSES}, {B_POSES // DP_RANKS} a rank, {STEPS} "
                  f"steps): warm-up {smp['warm']:.3f} s, timed {smp['secs']:.4f} s, {B_POSES / smp['secs']:.3f} "
                  f"poses/s (phase 5, one process: {poses_s:.3f}; two ranks share one card: no scaling); poses "
                  f"max_abs_err {err:.3g} A against phase 5's (tolerance {pos_tol:.3g} A); launches "
                  f"{smp['launches']}, expected from the config {smp['want']}", flush=True)
            if not err <= pos_tol or smp["launches"] != smp["want"]:
                fail("(H): the sample over the ranks disagrees with phase 5's or misses a kernel")
            print(f"(I) rank {r}, (n_data, n_model) = (1, {DP_RANKS}): {s2['n_cut']} leaves cut over the model axis; "
                  f"{s2['wall']:.3f} s", flush=True)
            dp_check(f"(I) rank {r}, 2-D step against one process", s2, ref0)
            if not s2["n_cut"]:
                fail("(I): no leaf is cut over the model axis")
        same = all(torch.equal(outs[0][k]["params"][n], o[k]["params"][n]) for o in outs[1:]
                   for k in ("step0", "step01", "step2d") for n in o[k]["params"])
        print(f"gloo's all_gather, given tensors on {device}: {outs[0]['gather']}", flush=True)
        print(f"(H)/(I): the ranks hold the same parameters after every step: {same}; the ranks' wall "
              f"{t_ranks:.1f} s, (G) {t_g:.1f} s", flush=True)
        if not same:
            fail("(H)/(I): the ranks' parameters differ")
        print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        sys.stdout.flush()
        sys.stdout = stdout
        shutil.rmtree(DP_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------- phase 19: DockGen-scale buckets


DOCKGEN_DIR = os.path.join(ROOT, "build", "dockgen")  # the complexes, embeddings, model directories, outputs; removed
DOCKGEN_SIZES = (900, 1800, 2800)  # residues of the complexes of seeds 0-2: the N=1024, 2048 and 3072 buckets
DOCKGEN_LIG = 22  # ligand atoms: the L=24 bucket of the stress run's 20-24
DOCKGEN_SAMPLES = 8  # poses of each complex, one batch (scripts/stress_eval_torch.py's)
DOCKGEN_FILES = ("rmsds", "centroid_distances", "confidences", "min_self_distances", "run_times", "complex_names",
                 "cold_variant")
CROSS_CAP_KEYS = ("cross_cap_dropped_edge_frac", "cross_cap_overflow_atom_frac", "cross_cap_dropped_edge_frac_final",
                  "cross_cap_overflow_atom_frac_final")


def dockgen_phase(dev, model, conf, card: str) -> list:
    """Phase 19 (see the module docstring); every line ends with the card's
    name and power limit. -> the JSON rows of the N=3072 complex's kernels."""
    import shutil

    stdout = sys.stdout
    sys.stdout = Tagged(stdout, card)
    shutil.rmtree(DOCKGEN_DIR, ignore_errors=True)
    try:
        return dockgen_run(dev, model, conf)
    finally:
        shutil.rmtree(DOCKGEN_DIR, ignore_errors=True)
        sys.stdout.flush()
        sys.stdout = stdout


def dockgen_run(dev, model, conf) -> list:
    """Three synthetic complexes (``scripts/stress_eval_torch.write_complex``,
    seeds 0-2) in the N=1024, 2048 and 3072 buckets with seeded ESM-sized
    embeddings, phase 5's score model and phase 6's confidence model as
    model directories, through ``cli.infer`` (8 poses x 20 steps, the
    all-atom rerank): a warm-up run, then a timed one (per-bucket run
    times); no failure, every artifact written, the cross-cap telemetry
    present. Then the N=3072 complex alone: its sample's and rerank's
    launches against the config, every kernel call of them recorded and
    replayed through kernel and plain version."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from stress_eval_torch import receptor_bucket, write_complex

    from confidence_bootstrapping_tpu_torch.cli import infer
    from confidence_bootstrapping_tpu_torch.train import checkpoints

    data, names, emb = os.path.join(DOCKGEN_DIR, "data"), [], {}
    for seed, n_res in enumerate(DOCKGEN_SIZES):
        names.append(f"dockgen{seed}_n{receptor_bucket(n_res)}")
        write_complex(data, names[-1], n_res, DOCKGEN_LIG, seed)
        emb[names[-1]] = torch.as_tensor(np.random.RandomState(seed).randn(n_res, LM_DIM).astype(np.float32))
    esm = os.path.join(DOCKGEN_DIR, "esm.pt")
    torch.save(emb, esm)
    dirs = {}
    for tag, m in (("score", model), ("confidence", conf)):
        dirs[tag] = os.path.join(DOCKGEN_DIR, tag)
        checkpoints.save_model_dir(dirs[tag], m.cfg, m)
    only = os.path.join(DOCKGEN_DIR, "n3072.txt")
    with open(only, "w") as f:
        f.write(names[-1] + "\n")

    def argv(out: str, *extra) -> list:
        return ["--data_dir", data, "--model_dir", dirs["score"], "--confidence_model_dir", dirs["confidence"],
                "--esm_embeddings_path", esm, "--samples_per_complex", str(DOCKGEN_SAMPLES), "--batch_size",
                str(DOCKGEN_SAMPLES), "--inference_steps", str(STEPS), "--cache_path", os.path.join(DOCKGEN_DIR, "cache"),
                "--out_dir", os.path.join(DOCKGEN_DIR, out), *extra]

    walls = {}
    for run_name in ("warm-up", "timed"):
        t0 = time.perf_counter()
        m = infer.main(argv(run_name))
        torch.cuda.synchronize()
        walls[run_name] = time.perf_counter() - t0
    out = os.path.join(DOCKGEN_DIR, "timed")
    missing = [a for a in DOCKGEN_FILES if not os.path.exists(os.path.join(out, f"{a}.npy"))]
    missing += [] if os.path.exists(os.path.join(out, "metrics.json")) else ["metrics.json"]
    run_times = np.load(os.path.join(out, "run_times.npy"))
    rmsds = np.load(os.path.join(out, "rmsds.npy"))
    loaded = [str(x) for x in np.load(os.path.join(out, "complex_names.npy"))]
    per_bucket = {receptor_bucket(n): float(rt) for n, nm, rt in zip(DOCKGEN_SIZES, names, run_times)}
    print(f"DockGen-scale evaluator: warm-up run {walls['warm-up']:.1f} s, timed run {walls['timed']:.1f} s; warm run "
          f"time per complex by receptor bucket (8 poses x {STEPS} steps + the rerank, s): {per_bucket}; "
          f"cross cap {m.get('cross_cap')}: " + ", ".join(f"{k} {m.get(k)}" for k in CROSS_CAP_KEYS), flush=True)
    if m["failures"] or m["n_complexes"] != len(names) or loaded != names:
        fail(f"DockGen-scale evaluator: {m['failures']} failures, {m['n_complexes']} complexes ({loaded})")
    if missing or any(m.get(k) is None for k in CROSS_CAP_KEYS):
        fail(f"DockGen-scale evaluator: artifacts missing {missing} or cross-cap telemetry absent")
    if not (np.isfinite(rmsds).all() and (rmsds < 1e4).all()):
        fail("DockGen-scale evaluator: RMSDs not finite")

    names_k = KERNELS + CONF_KERNELS
    calls, launches, plain = counted_all(lambda: record_calls(
        lambda: infer.main(argv("n3072", "--names_file", only)), names_k))
    want = {name: 0 for name in all_counters()}
    want.update(expected_launches(model, STEPS))
    want.update(expected_conf_launches(conf))
    print(f"N=3072 complex through cli.infer: launches {nonzero(launches)}, expected from the config "
          f"{nonzero(want)}; plain versions called {plain}; recorded calls "
          f"{ {k: len(v) for k, v in calls.items()} }", flush=True)
    if launches != want or any(plain.values()):
        fail("DockGen scale: the N=3072 sample and rerank did not run every TP-conv through its kernel")
    check_tc_builds({"tpconv_cross_g": calls["tpconv_cross_g"]}, "N=3072 rerank")
    kernels = dict(sample_kernels())
    kernels.update({k: v for k, v in remainder_kernels().items() if k in CONF_KERNELS})
    with torch.no_grad():
        rows = replay(calls, kernels, bitwise=("tpconv_rec", "tpconv_pb") + CONF_KERNELS)
    del calls
    torch.cuda.empty_cache()
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["name"] += ", DockGen N=3072"
    return rows


def main() -> None:
    import torch

    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 18, spawned by it
        dp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    t_script = time.perf_counter()
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
        fail(f"{', '.join(TC_KERNELS)} must run their H x W products on the tensor cores")
    spills = tc_spills(logs)
    print(f"tensor-core kernels' spill stores (ptxas): {spills}", flush=True)
    check_tc_spills(spills)
    walls, t_lap = {"1-2": time.perf_counter() - t_script}, [time.perf_counter()]

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t_lap[0], 1)
        t_lap[0] = time.perf_counter()

    model, b0, run = main_path(dev)
    rows = kernel_phase(model, run)
    torch.cuda.synchronize()
    lap("3")
    model_phase(dev)
    lap("4")
    launches, final_pos, poses_s = sample_phase(model, b0, run)
    pos_tol = sample_tolerance(model, b0, final_pos)  # for phases 10, 15 and 18
    lap("5")
    conf_rows, conf_launches, rerank = confidence_phase(dev, final_pos)
    lap("6")
    train_rows, train_launches = train_phase(dev)
    lap("7")
    eval_launches, calls = eval_phase(dev, rerank)
    torch.cuda.synchronize()
    pairs_launches, calls_8b = composed_pairs_phase(dev)
    calls.update(calls_8b)
    check_tc_builds(calls, "evaluator and composed-pairs samples")
    eval_rows = replay(calls, eval_kernels(), bitwise=("tpconv_cross", "tpconv_nbr", "tpconv_msgs"))
    for r in eval_rows[1:]:  # rows 5 and 6 launch the edge-list kernel's inference instance
        r["source"] = "confidence_bootstrapping_tpu_torch/csrc/tpconv_edge.cu"
    replay_v1(calls)
    lap("8, 8b")
    wide_phase(dev)
    lap("9")
    model_dir_phase(dev, model, b0, final_pos, rerank, pos_tol)
    lap("10")
    cb_phase(dev, rerank[0], card)
    lap("11")
    conf_train_rows, conf_train_launches = conf_train_phase(dev, model, card)
    lap("12")
    serve_files_phase(dev, model, rerank[0], card, poses_s)
    lap("13")
    train_files_phase(dev, card)
    lap("14")
    legacy_phase(dev, model, rerank[0], b0, final_pos, rerank, card, pos_tol)
    lap("15")
    remainder_rows = remainder_phase(dev, rerank, card)
    lap("16")
    sh3_rows = sh3_phase(dev, rerank, card)
    lap("17")
    dp_phase(dev, b0, final_pos, model, poses_s, card, pos_tol)
    lap("18")
    dockgen_rows = dockgen_phase(dev, model, rerank[0], card)
    lap("19")

    launches.update(conf_launches)
    launches.update(train_launches)
    launches.update(conf_train_launches)
    launches.update(tpconv_cross=eval_launches["tpconv_cross"], tpconv_msgs=eval_launches["tpconv_msgs"],
                    tpconv_nbr=pairs_launches["tpconv_nbr"])
    rows += conf_rows + train_rows + conf_train_rows + eval_rows
    for r in rows:
        r["launches"] = launches[r["name"]]
    rows += remainder_rows  # phase 16's path C, launches per sample or training step of that path
    rows += sh3_rows  # phase 17's (D), launches per sample or training step
    rows += dockgen_rows  # phase 19's N=3072 complex, launches per evaluator batch (sample) or rerank
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_script:.1f} s; walls by phase (s): {walls}",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
