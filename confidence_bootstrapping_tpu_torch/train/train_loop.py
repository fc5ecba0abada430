"""One score-model training step: noise, forward, loss, backward, NaN skip,
Adam and EMA; the eval step; and the epoch loops around them.

Port of ``confidence_bootstrapping_tpu/train/train_loop.py``
(``make_optimizer``, ``init_train_state``, ``layer_freeze_mask``,
``make_train_step``, ``make_eval_step``, ``AverageMeter``,
``PlateauScheduler``, ``train_epoch``, ``test_epoch``). PyTorch runs
eagerly, so the step is a plain function of a mutable ``TrainState`` that
updates the model, the optimizer and the EMA copy in place. Three places
copy the JAX step's arithmetic rather than a PyTorch built-in:

* the NaN skip: a step whose loss is not finite zeroes its gradients but
  still runs the Adam update (moments decay, the step count grows, the
  parameters move by the bias-corrected moments) and the EMA, and keeps the
  batch statistics the step started with (``train_loop.py:195-209``);
* gradient clipping is optax's ``clip_by_global_norm``;
* the progressive-unfreezing mask multiplies the gradients after the NaN
  zeroing and before clipping, and a masked parameter still takes its Adam
  (or AdamW) step, as under ``optax.chain(clip, adam)`` (``train_loop.py:
  193-198``).

The torsional pretraining steps (``make_torsional_train_step``,
``make_torsional_eval_step``) run ``torsional_forward`` on the torsion-only
noise and loss of ``data/torsional`` through the same update, with the JAX
torsional step's two differences kept: the EMA decays at ``ema_rate`` from
the first step, and the batch statistics the step produced are kept even
when its loss is not finite (``train_loop.py:249-256``).
"""

from __future__ import annotations

import re
import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..config import ScoreModelConfig, TrainConfig
from ..data.complex_graph import ComplexBatch
from ..data.torsional import torsional_apply_noise, torsional_loss
from ..models.from_flax import flax_path
from ..parallel import mesh as meshlib
from .diffusion import apply_noise
from .losses import LossBreakdown, score_matching_loss


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]  # EMA copy of every parameter
    step: int = 0
    lr_scale: float = 1.0  # host-controlled plateau scaling of the learning rate
    grad_clip: Optional[float] = None  # the chain's clip, as built at init (optax's state nests one level deeper)
    # the 2-D split (parallel/mesh.shard_model_tree): parameter name -> (dim, start, length, this rank's slice),
    # the leaf the optimizer and the EMA hold for a parameter cut over the mesh's model axis
    shards: Dict[str, Tuple[int, int, int, torch.nn.Parameter]] = field(default_factory=dict)
    mesh: Optional[meshlib.Mesh] = None
    model_axis: str = "model"


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW (decoupled weight decay) when ``w_decay`` is set, with
    optax's defaults (betas 0.9/0.999, eps 1e-8)."""
    if cfg.w_decay:
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.w_decay)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    """Unfreeze the model's parameters; a fresh optimizer; EMA = parameters."""
    model.requires_grad_(True)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, make_optimizer(list(model.parameters()), cfg), ema, grad_clip=cfg.grad_clip)


def batch_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the model's buffers (the batch norms' running statistics)."""
    return {n: b.detach().clone() for n, b in model.named_buffers()}


@torch.no_grad()
def keep_batch_stats(model: torch.nn.Module, saved: Dict[str, torch.Tensor], ok) -> None:
    """Keep the buffers a step produced where ``ok`` (a bool tensor), else
    put back ``saved``: the JAX step's ``where(ok, new, old)``."""
    for n, b in model.named_buffers():
        b.copy_(torch.where(ok, b, saved[n]))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: every gradient times max_norm / norm when
    the global norm reaches max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return [g * scale for g in grads]


# modules unfrozen from step 0 (reference utils/utils.py:143-145: the heads)
_WARMUP_HEAD_MODULES = (
    "center_edge_embedding", "final_conv", "tr_final_layer", "rot_final_layer",
    "final_edge_embedding", "tor_bond_conv", "tor_final_layer",
    "confidence_predictor", "atom_confidence_predictor", "sidechain_predictor",
)


def layer_freeze_mask(model: torch.nn.Module, step: int) -> Dict[str, float]:
    """{parameter name: 1.0 or 0.0}, the reference's layer_linear_warmup
    progressive unfreezing (utils/utils.py:135-153), decided on each
    parameter's Flax path (``models.from_flax.flax_path``) as the JAX
    package decides it:

    * step 0: only the output heads and every batch-norm parameter train;
    * step s in 1..num_conv_layers: additionally conv_layers[-s] (top-down);
    * step > num_conv_layers: everything (input embeddings + emb layers too).
    """
    paths = {n: flax_path(model, n)[0] for n, _ in model.named_parameters()}
    layer_ids = {int(m.group(1)) for p in paths.values() for m in [re.match(r"conv_layers_(\d+)", p[0])] if m}
    n_conv = max(layer_ids) + 1 if layer_ids else 0
    conv_cutoff = n_conv - min(max(step, 0), n_conv)  # conv idx >= cutoff train
    all_unfrozen = step > n_conv

    def mask(path) -> float:
        # batch-norm params are never frozen (reference keeps any param whose
        # name contains 'batch_norm' trainable at step 0)
        if any(k == "bn" or k.startswith("MaskedBatchNorm") for k in path):
            return 1.0
        if path[0] in _WARMUP_HEAD_MODULES:
            return 1.0
        m = re.match(r"conv_layers_(\d+)", path[0])
        if m:
            return 1.0 if int(m.group(1)) >= conv_cutoff else 0.0
        # embeddings + rec/lig emb layers unfreeze only at the final step
        return 1.0 if all_unfrozen else 0.0

    return {n: mask(p) for n, p in paths.items()}


@torch.no_grad()
def apply_gradients(state: TrainState, grads, ok, cfg: TrainConfig, grad_mask: Optional[Dict[str, float]] = None,
                    ema_warmup: bool = True) -> None:
    """The update half of the step, given each parameter's gradient (None
    counts as zero) and ``ok`` (bool tensor: the loss was finite): NaN skip,
    the gradient mask (``layer_freeze_mask``), clipping at the state's
    ``grad_clip`` (the chain ``init_train_state`` built, as optax's lives in
    the JAX state), Adam or AdamW at lr * lr_scale on every parameter, EMA
    with decay min(ema_rate, (1 + step) / (10 + step)) (``ema_warmup``) or
    ema_rate, step + 1. A parameter cut over a 2-D mesh's model axis
    (``state.shards``) takes the update and the EMA on this rank's slice,
    and the slices are then gathered into the whole parameter."""
    named = list(state.model.named_parameters())
    params = [p for _, p in named]
    grads = [torch.where(ok, g, torch.zeros_like(g)) if g is not None else torch.zeros_like(p)
             for g, p in zip(grads, params)]
    if grad_mask is not None:
        grads = [g * grad_mask[n] for g, (n, _) in zip(grads, named)]
    if state.grad_clip:
        grads = clip_by_global_norm(grads, state.grad_clip)
    leaves = [state.shards[n][3] if n in state.shards else p for n, p in named]
    for (n, _), leaf, g in zip(named, leaves, grads):
        leaf.grad = g.narrow(*state.shards[n][:3]) if n in state.shards else g
    for group in state.optimizer.param_groups:
        group["lr"] = cfg.lr * state.lr_scale
    state.optimizer.step()
    for leaf in leaves:
        leaf.grad = None
    decay = min(cfg.ema_rate, (1 + state.step) / (10 + state.step)) if ema_warmup else cfg.ema_rate
    for (n, _), leaf in zip(named, leaves):
        state.ema[n].mul_(decay).add_(leaf, alpha=1 - decay)
    if state.shards:
        meshlib.gather_model_tree(state)
    state.step += 1


def _reduced(dp: Optional[meshlib.Mesh], state: TrainState, loss: torch.Tensor, params, shares):
    """(gradients, global metric values): the gradients of this rank's
    share of the loss and the metric shares (a 1-D tensor), each summed over
    the data axis when ``dp``; on a 2-D state, the model axis's first
    rank's."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    if dp is not None:
        with meshlib.data_parallel(dp):
            grads, shares = meshlib.reduce_gradients(dp, grads, params), meshlib.psum(shares)
    if state.shards:
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        meshlib.agree(state.mesh, grads + [shares], state.model_axis)
    return grads, shares


def _context(dp: Optional[meshlib.Mesh]):
    return meshlib.data_parallel(dp) if dp is not None else contextlib.nullcontext()


def make_train_step(model_cfg: ScoreModelConfig, cfg: TrainConfig, mesh: Optional[meshlib.Mesh] = None) -> Callable:
    """-> step(state, batch, generator, mark=None, grad_mask=None) -> metrics
    (0-d tensors, not synchronized). ``mark(name)``, when given, is called
    after the noise and forward ("forward"), after the backward ("backward")
    and after the update ("update"), e.g. to record CUDA events.
    ``grad_mask``: ``layer_freeze_mask``'s dict, or None.

    ``mesh`` (``parallel.mesh``): data parallel over its "data" axis. Every
    rank passes the same global batch and generator state; the noise is
    applied to the global batch, each rank runs its slice inside
    ``mesh.data_parallel`` (batch statistics over the global valid rows,
    dropout masks drawn at the global rows, loss denominators global), the
    gradients and metrics are summed over the ranks, and the NaN skip and
    clipping then decide alike on every rank: the step equals the
    one-process step on the global batch. A 2-D state
    (``mesh.shard_model_tree``) updates its slices of the cut leaves."""

    def step(state: TrainState, batch: ComplexBatch, generator: torch.Generator, mark: Optional[Callable] = None,
             grad_mask: Optional[Dict[str, float]] = None):
        model = state.model
        noised, targets = apply_noise(batch, model_cfg.sigma, cfg, generator, model_cfg.no_torsion)
        dp = meshlib.data_mesh(mesh, batch.batch_size)
        if dp is not None:
            noised, targets = meshlib.shard_batch(dp, noised), meshlib.shard_batch(dp, targets)
        saved = batch_stats(model)
        with _context(dp):
            out = model(noised, deterministic=False, use_running_average=False, generator=generator)
            lb = score_matching_loss(out.tr_pred, out.rot_pred, out.tor_pred, targets, noised, model_cfg.sigma,
                                     cfg.tr_weight, cfg.rot_weight, cfg.tor_weight, model_cfg.no_torsion)
        if mark:
            mark("forward")
        params = [p for _, p in model.named_parameters()]
        grads, totals = _reduced(dp, state, lb.loss, params, torch.stack([v.detach() for v in lb]))
        lb = LossBreakdown(*totals.unbind())
        if mark:
            mark("backward")
        ok = torch.isfinite(lb.loss)
        apply_gradients(state, grads, ok, cfg, grad_mask)
        keep_batch_stats(model, saved, ok)
        if state.shards:
            meshlib.agree(state.mesh, list(model.buffers()), state.model_axis)
        if mark:
            mark("update")
        metrics = dict(lb._asdict())
        metrics["skipped"] = (~ok).to(torch.float32)
        return metrics

    return step


def make_eval_step(model_cfg: ScoreModelConfig, cfg: TrainConfig, use_running_average: bool = True) -> Callable:
    """-> eval(state, batch, generator) -> metrics. Deterministic (no
    dropout); ``use_running_average=False`` normalizes with the eval batch's
    own statistics and leaves the running ones as they were (for a model
    trained on one replicated complex, where running-statistics eval blows
    up)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: ComplexBatch, generator: torch.Generator):
        model = state.model
        noised, targets = apply_noise(batch, model_cfg.sigma, cfg, generator, model_cfg.no_torsion)
        saved = batch_stats(model)
        out = model(noised, deterministic=True, use_running_average=use_running_average)
        keep_batch_stats(model, saved, torch.zeros((), dtype=torch.bool, device=noised.lig_pos.device))
        lb = score_matching_loss(out.tr_pred, out.rot_pred, out.tor_pred, targets, noised, model_cfg.sigma,
                                 cfg.tr_weight, cfg.rot_weight, cfg.tor_weight, model_cfg.no_torsion)
        return dict(loss=lb.loss, tr_loss=lb.tr_loss, rot_loss=lb.rot_loss, tor_loss=lb.tor_loss,
                    t=torch.mean(noised.t_tr))

    return eval_step


def make_torsional_train_step(model_cfg: ScoreModelConfig, cfg: TrainConfig,
                              mesh: Optional[meshlib.Mesh] = None) -> Callable:
    """-> step(state, batch, generator, grad_mask=None) -> metrics {loss,
    tor_base_loss, skipped}: torsion-only noise, ``torsional_forward`` in
    training, ``torsional_loss``, then ``apply_gradients`` with the EMA at
    ``ema_rate`` and the step's batch statistics kept (the JAX torsional
    step's arithmetic). ``grad_mask`` and ``mesh`` as in
    ``make_train_step``."""

    def step(state: TrainState, batch: ComplexBatch, generator: torch.Generator,
             grad_mask: Optional[Dict[str, float]] = None):
        model = state.model
        noised, targets = torsional_apply_noise(batch, model_cfg.sigma, cfg, generator)
        dp = meshlib.data_mesh(mesh, batch.batch_size)
        if dp is not None:
            noised, targets = meshlib.shard_batch(dp, noised), meshlib.shard_batch(dp, targets)
        with _context(dp):
            tor_pred = model.torsional_forward(noised, deterministic=False, use_running_average=False,
                                               generator=generator)
            loss, base = torsional_loss(tor_pred, targets, noised)
        params = [p for _, p in model.named_parameters()]
        grads, totals = _reduced(dp, state, loss, params, torch.stack([loss.detach(), base.detach()]))
        loss, base = totals.unbind()
        ok = torch.isfinite(loss)
        apply_gradients(state, grads, ok, cfg, grad_mask, ema_warmup=False)
        if state.shards:
            meshlib.agree(state.mesh, list(model.buffers()), state.model_axis)
        return {"loss": loss, "tor_base_loss": base, "skipped": (~ok).to(torch.float32)}

    return step


def make_torsional_eval_step(model_cfg: ScoreModelConfig, cfg: TrainConfig) -> Callable:
    """-> eval(state, batch, generator) -> {loss, tor_base_loss}: torsion-only
    noise and ``torsional_forward`` at inference (running statistics, no
    dropout)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: ComplexBatch, generator: torch.Generator):
        noised, targets = torsional_apply_noise(batch, model_cfg.sigma, cfg, generator)
        loss, base = torsional_loss(state.model.torsional_forward(noised), targets, noised)
        return {"loss": loss, "tor_base_loss": base}

    return eval_step


class AverageMeter:
    """Running means of metric dicts, optionally bucketed by t-interval
    (reference utils/training.py:152-181)."""

    def __init__(self, intervals: int = 1):
        self.intervals = intervals
        self.sums = {}
        self.counts = {}

    def add(self, metrics: dict, t: Optional[float] = None):
        bucket = 0 if self.intervals == 1 or t is None else min(int(t * self.intervals), self.intervals - 1)
        for k, v in metrics.items():
            key = (k, bucket)
            self.sums[key] = self.sums.get(key, 0.0) + float(v)
            self.counts[key] = self.counts.get(key, 0) + 1

    def summary(self) -> dict:
        out = {}
        totals: dict = {}
        for (k, b), s in self.sums.items():
            name = k if self.intervals == 1 else f"{k}_interval{b}"
            out[name] = s / self.counts[(k, b)]
            ts, tc = totals.get(k, (0.0, 0))
            totals[k] = (ts + s, tc + self.counts[(k, b)])
        if self.intervals > 1:
            # overall means under the plain keys so consumers (schedulers,
            # early stopping) keep working when bucketing is on
            for k, (s, c) in totals.items():
                out[k] = s / c
        return out


class PlateauScheduler:
    """Host-side ReduceLROnPlateau over ``TrainState.lr_scale``: after more
    than ``patience`` epochs without a better metric, lr_scale *= factor."""

    def __init__(self, patience: int = 30, factor: float = 0.7, goal: str = "min"):
        self.patience = patience
        self.factor = factor
        self.goal = goal
        self.best = None
        self.bad_epochs = 0

    def step(self, state: TrainState, metric: float) -> TrainState:
        better = self.best is None or (metric < self.best if self.goal == "min" else metric > self.best)
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                state.lr_scale = state.lr_scale * self.factor
        return state


def train_epoch(train_step: Callable, state: TrainState, batches: Iterable, generator: torch.Generator,
                grad_mask: Optional[Dict[str, float]] = None):
    """One pass of ``train_step`` over ``batches``: (state, the metrics'
    means)."""
    meter = AverageMeter()
    for batch in batches:
        metrics = train_step(state, batch, generator) if grad_mask is None else \
            train_step(state, batch, generator, grad_mask=grad_mask)
        meter.add({k: float(v) for k, v in metrics.items()})
    return state, meter.summary()


def test_epoch(eval_step: Callable, state: TrainState, batches: Iterable, generator: torch.Generator,
               intervals: int = 1) -> dict:
    """The means of ``eval_step``'s metrics over ``batches``, bucketed by the
    batch's mean t (its ``t`` entry, popped) into ``intervals``."""
    meter = AverageMeter(intervals)
    for batch in batches:
        metrics = dict(eval_step(state, batch, generator))
        t = float(metrics.pop("t")) if "t" in metrics else None
        meter.add({k: float(v) for k, v in metrics.items()}, t=t)
    return meter.summary()
