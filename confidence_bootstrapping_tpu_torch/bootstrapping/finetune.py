"""The Confidence-Bootstrapping driver: rollout -> filter -> buffer -> train.

Port of ``confidence_bootstrapping_tpu/bootstrapping/finetune.py`` (the
reference's ``finetune_train.py:133-349``):

  * ``inference_epoch``: sample ``inference_samples`` poses per target
    complex with the (EMA) score model, compute symmetry RMSDs against the
    crystal pose, score the poses with the confidence model (or -RMSD, or
    zero), and keep those above the confidence cutoff;
  * ``inference_finetune``: alternate rollout rounds (``initial_iterations``
    on epoch 0, then ``inference_iterations`` every ``cb_inference_freq``
    epochs) with score-matching fine-tune epochs on the buffer, rolling out
    with the EMA weights (reference :270-273) and checkpointing each epoch.

PyTorch idiom: the model holds its weights, so no variables are passed; one
``torch.Generator`` on the device stands in for the split keys; the
``TrainState`` is mutable and trains the model it is given. Rollouts run a
second model of the same config (``rollout_weights``): the EMA parameters
(or the current ones) with the training model's batch statistics as they are
at that moment, copied under ``no_grad`` with ``copy_`` so that each
weight's version moves and the TP-convs repack their kernel weights. A
rollout leaves the training model, its optimizer and its EMA untouched.
Every entry point runs on the GPU unless the caller passes ``device="cpu"``.

``dp_mesh`` (``parallel.mesh``): the rollouts' pose batches and the
fine-tune batches split over the mesh's ranks (when they split evenly, as
the JAX loop's ``n % size`` guard asks). Every rank draws the same prior and
noise and gathers the poses, so the RMSDs, the confidences and the buffer's
picks (its own seeded generator) are the same on every rank; the fine-tune
steps equal the one-process steps. Rank 0 alone writes the workdir, and
every rank returns rank 0's history.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CBConfig, SamplerConfig, ScoreModelConfig, TrainConfig
from ..data.complex_graph import HostComplex, batch_complexes, pad_complex, pick_bucket, replicate_complex
from ..eval import rmsd as rmsd_mod
from ..models.factory import get_model
from ..parallel import mesh as meshlib
from ..runtime import resolve_device
from ..sampler import sampling
from ..train import checkpoints, train_loop
from .buffer import CBBuffer


class CBTarget:
    """One target complex: host arrays + padded template + topology for RMSD."""

    def __init__(self, hc: HostComplex, mol_heavy, lm_dim: int = 0, bucket=None):
        self.hc = hc
        self.mol = mol_heavy  # Molecule (heavy atoms) for symmetry RMSD
        self.bucket = bucket or pick_bucket(
            len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
            n_atoms=0 if hc.atom_f is None else len(hc.atom_f),
            all_atoms=hc.atom_f is not None,
        )
        self.lm_dim = lm_dim
        self.padded = pad_complex(hc, self.bucket, lm_dim=lm_dim)
        self.name = hc.name


def finetune_config(cb: CBConfig) -> TrainConfig:
    """The fine-tune's training config, as the JAX loop builds it."""
    return TrainConfig(
        lr=cb.lr,
        batch_size=cb.batch_size,
        minimum_t=cb.minimum_t,
        sampling_mixing_coeff=cb.sampling_mixing_coeff,
        sampling_alpha=cb.sampling_alpha,
        sampling_beta=cb.sampling_beta,
        tr_weight=0.33, rot_weight=0.33, tor_weight=0.33,
    )


@torch.no_grad()
def rollout_weights(roll_model: torch.nn.Module, state: train_loop.TrainState, use_ema: bool = True):
    """Load ``roll_model`` for a rollout: the state's EMA parameters (or its
    current ones) and the training model's buffers. Returns ``roll_model``."""
    src = state.ema if use_ema else dict(state.model.named_parameters())
    for n, p in roll_model.named_parameters():
        p.copy_(src[n])
    buffers = dict(state.model.named_buffers())
    for n, b in roll_model.named_buffers():
        b.copy_(buffers[n])
    return roll_model


def rollout_poses(model, target: CBTarget, n: int, generator: torch.Generator, model_cfg: ScoreModelConfig,
                  sampler_cfg: SamplerConfig, dev, dp_mesh=None) -> torch.Tensor:
    """``n`` poses of the target's ligand, [n, L, 3] on ``dev``: a random
    placement, then the reverse diffusion (over ``dp_mesh``'s ranks)."""
    batch = replicate_complex(target.padded, n, device=dev)
    batch = sampling.randomize_position(batch, generator, model_cfg.sigma.tr_sigma_max)
    final, _ = sampling.sample(model, batch, model_cfg, sampler_cfg, generator, device=dev, mesh=dp_mesh)
    return final.lig_pos[:, : len(target.hc.lig_f)]


def pose_confidences(confidence_fn: Optional[Callable], target: CBTarget, poses: torch.Tensor) -> np.ndarray:
    """confidence_fn(target, poses) on the host (tensor or array), or zeros
    without a confidence function."""
    if confidence_fn is None:
        return np.zeros(len(poses))
    c = confidence_fn(target, poses)
    return c.detach().cpu().numpy() if torch.is_tensor(c) else np.asarray(c)


def confidence_function(conf_model) -> Callable:
    """The CLIs' confidence function (JAX ``cli/finetune.py:147-157``):
    fn(target, poses [n, L, 3] on the device) -> the confidences [n] of
    ``conf_model`` on the target replicated n times at those poses."""

    def fn(target: CBTarget, poses: torch.Tensor) -> torch.Tensor:
        batch = replicate_complex(target.padded, len(poses), device=poses.device)
        lp = batch.lig_pos.clone()
        lp[:, : poses.shape[1]] = poses
        return sampling.score_confidence(conf_model, batch, lig_pos=lp)

    return fn


def keep_poses(target: CBTarget, host: np.ndarray, confidences, cutoff: float) -> List[Tuple[int, Tuple[dict, str, float]]]:
    """The poses ``host`` [n, L, 3] whose confidence is above ``cutoff``:
    (index, buffer item), the item being (the padded complex at the pose,
    the target's name, the confidence)."""
    kept = []
    for i in range(len(host)):
        if confidences[i] > cutoff:
            item = dict(target.padded)
            lig_pos = item["lig_pos"].copy()
            lig_pos[: host.shape[1]] = host[i]
            item["lig_pos"] = lig_pos
            kept.append((i, (item, target.name, float(confidences[i]))))
    return kept


def inference_epoch(
    model,
    targets: Sequence[CBTarget],
    generator: torch.Generator,
    model_cfg: ScoreModelConfig,
    cb: CBConfig,
    confidence_fn: Optional[Callable] = None,
    device=None,
    dp_mesh=None,
) -> Tuple[List[Tuple[dict, str, float]], Dict]:
    """One rollout round over the target complexes, on ``device`` (default:
    the GPU), where ``model`` and ``generator`` must be.

    confidence_fn(target, lig_pos [n, L, 3] tensor on the device) ->
    confidence [n] (tensor or array); None together with
    oracle_confidence=False keeps every pose with confidence 0. A target
    whose round raises is skipped, up to ``cb.limit_failures`` of them
    (reference finetune_train.py:171-197). ``dp_mesh``: the rollouts split
    over its ranks. Returns (kept buffer items, metrics dict)."""
    dev = resolve_device(device)
    sampler_cfg = SamplerConfig(inference_steps=cb.inference_steps)
    kept: List[Tuple[dict, str, float]] = []
    _plan_cache: Dict[str, SamplerConfig] = {}

    def _sampler_cfg_for(target) -> SamplerConfig:
        # the phased receptor compaction plan, derived once per target
        # (rec_phase_auto, as the JAX package's CB rollouts derive it)
        sc = _plan_cache.get(target.name)
        if sc is None:
            sc = _plan_cache[target.name] = sampling.with_derived_plan(
                model_cfg, sampler_cfg, target.padded["rec_pos"], target.padded["rec_mask"])
        return sc

    all_rmsds, all_confidences, kept_rmsds = [], [], []
    n_failures = 0
    # rollout = batch build + reverse diffusion up to the poses on the host,
    # rmsd = symmetry RMSD, confidence = confidence-model scoring
    wall = dict(rollout=0.0, rmsd=0.0, confidence=0.0)

    for target in targets[: cb.num_inference_complexes or len(targets)]:
        try:
            t0 = time.perf_counter()
            poses = rollout_poses(model, target, cb.inference_samples, generator, model_cfg, _sampler_cfg_for(target),
                                  dev, dp_mesh)
            host = poses.cpu().numpy()
            wall["rollout"] += time.perf_counter() - t0

            # symmetry-corrected, min over all valid ground-truth binding
            # poses (reference get_symmetry_rmsd over the orig_pos list)
            t0 = time.perf_counter()
            rmsds = rmsd_mod.symmetry_rmsd(
                rmsd_mod.ground_truth_poses(target.hc), poses, target.mol.atomic_nums, target.mol.bonds
            )
            wall["rmsd"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            confidences = -rmsds if cb.oracle_confidence else pose_confidences(confidence_fn, target, poses)
            wall["confidence"] += time.perf_counter() - t0

            all_rmsds.extend(rmsds.tolist())
            all_confidences.extend(np.atleast_1d(confidences).tolist())
            for i, item in keep_poses(target, host, confidences, cb.confidence_cutoff):
                kept.append(item)
                kept_rmsds.append(float(rmsds[i]))
        except Exception as e:  # skip-and-continue (reference finetune_train.py:171-197)
            n_failures += 1
            print(f"inference failed on {target.name}: {type(e).__name__}: {e}")
            traceback.print_exc()
            if n_failures > cb.limit_failures:
                raise

    all_rmsds = np.asarray(all_rmsds) if all_rmsds else np.zeros(0)
    metrics = dict(
        n_sampled=len(all_rmsds),
        n_kept=len(kept),
        rmsds_lt2=float(np.mean(all_rmsds < 2)) if len(all_rmsds) else 0.0,
        rmsds_lt5=float(np.mean(all_rmsds < 5)) if len(all_rmsds) else 0.0,
        kept_rmsds_lt2=float(np.mean(np.asarray(kept_rmsds) < 2)) if kept_rmsds else 0.0,
        mean_rmsd=float(all_rmsds.mean()) if len(all_rmsds) else 0.0,
        mean_confidence=float(np.mean(all_confidences)) if all_confidences else 0.0,
        failures=n_failures,
        kept_rmsds=list(kept_rmsds),  # per-pose RMSDs of the confidence-filtered poses
        wall_rollout=wall["rollout"],
        wall_rmsd=wall["rmsd"],
        wall_confidence=wall["confidence"],
    )
    return kept, metrics


def inference_finetune(
    model,
    targets: Sequence[CBTarget],
    model_cfg: ScoreModelConfig,
    cb: CBConfig,
    generator: torch.Generator,
    confidence_fn: Optional[Callable] = None,
    workdir: Optional[str] = None,
    original_dataset=None,
    device=None,
    dp_mesh=None,
):
    """The full CB loop on ``device`` (default: the GPU), where ``model`` and
    ``generator`` must be; ``model`` is the one trained. Returns (final
    TrainState, metric history).

    ``original_dataset`` (``keep_original_train``): a
    ``data.dataset.ComplexDataset`` on the device, or anything else with
    ``len`` and ``epoch_batches(batch_size, rng)`` -> a list of
    ``ComplexBatch`` there; its batches alternate with the buffer's.
    ``dp_mesh``: rollouts and fine-tune steps over its ranks (module
    docstring)."""
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"inference_finetune on {dev}: move the model there first")
    tcfg = finetune_config(cb)
    state = train_loop.init_train_state(model, tcfg)
    train_step = train_loop.make_train_step(model_cfg, tcfg, mesh=dp_mesh)
    writer = dp_mesh is None or dp_mesh.rank == 0  # rank 0 alone writes the workdir
    roll_model = get_model(model.cfg, device=dev).requires_grad_(False)

    buffer = CBBuffer(
        cluster_ligands=[t.name for t in targets],
        max_complexes_per_couple=cb.max_complexes_per_couple,
        fixed_length=cb.fixed_length,
        temperature=cb.temperature,
        buffer_decay=cb.buffer_decay,
        reset_buffer=cb.reset_buffer,
    )
    history = []
    filtered_rmsds: list = []  # RMSDs of every confidence-kept pose across the run

    for epoch in range(cb.n_epochs):
        t0 = time.perf_counter()
        if epoch % cb.cb_inference_freq == 0:
            n_iters = cb.initial_iterations if epoch == 0 else cb.inference_iterations
            # rollouts use EMA weights (reference finetune_train.py:270-273)
            rollout_weights(roll_model, state, cb.use_ema_for_rollouts)
            inf_metrics = {}
            for it in range(n_iters):
                kept, inf_metrics = inference_epoch(roll_model, targets, generator, model_cfg, cb, confidence_fn,
                                                    device=dev, dp_mesh=dp_mesh)
                filtered_rmsds.extend(inf_metrics.pop("kept_rmsds", []))
                buffer.add_complexes(kept)
                print(f"epoch {epoch} rollout {it}: kept {inf_metrics['n_kept']}/{inf_metrics['n_sampled']}, "
                      f"rmsds<2A {inf_metrics['rmsds_lt2']:.3f}, buffer {buffer.statistics()['size']}")

        # finetune on the buffer (optionally mixed with original train
        # batches, reference --keep_original_train finetune_train.py:116-126;
        # batches alternate because bucket shapes must stay uniform per batch)
        train_metrics = {}
        t_train0 = time.perf_counter()
        if len(buffer.complexes) > 0:
            n_batches = max(1, len(buffer) // cb.batch_size)
            meter = train_loop.AverageMeter()
            orig_batches = []
            if cb.keep_original_train and original_dataset is not None and len(original_dataset) > 0:
                rng = np.random.RandomState(epoch)
                orig_batches = original_dataset.epoch_batches(cb.batch_size, rng)[: max(1, n_batches)]
            for bi in range(n_batches + len(orig_batches)):
                if bi % 2 == 1 and orig_batches:
                    batch = orig_batches.pop()
                else:
                    batch = batch_complexes(buffer.sample_batch(cb.batch_size), device=dev)
                metrics = train_step(state, batch, generator)
                meter.add({m: float(v) for m, v in metrics.items()})
            train_metrics = meter.summary()

        entry = dict(epoch=epoch, buffer=buffer.statistics(), train=train_metrics,
                     wall=time.perf_counter() - t0, wall_train=time.perf_counter() - t_train0)
        if epoch % cb.cb_inference_freq == 0:
            entry["inference"] = inf_metrics
        history.append(entry)
        print(f"epoch {epoch}: loss {train_metrics.get('loss', float('nan')):.4f} ({entry['wall']:.1f}s)")

        if workdir and writer:
            os.makedirs(workdir, exist_ok=True)
            checkpoints.save_params(os.path.join(workdir, "last_model.msgpack"), state.model)
            checkpoints.save_params(os.path.join(workdir, "ema_model.msgpack"), state.model, params=state.ema)
            with open(os.path.join(workdir, "metrics.pkl"), "wb") as f:
                pickle.dump(history, f)
            # RMSDs of every confidence-filtered pose (reference
            # finetune_train.py:348-349 --save_final_rmsds)
            np.save(os.path.join(workdir, "final_filtered_rmsds.npy"), np.asarray(filtered_rmsds))
        if dp_mesh is not None:  # the others wait for rank 0's files
            meshlib.coordinator_barrier(f"cb_epoch{epoch}")

    if dp_mesh is not None:  # rank 0's history, with its wall times
        history = meshlib.broadcast_object(dp_mesh, history)
    return state, history
