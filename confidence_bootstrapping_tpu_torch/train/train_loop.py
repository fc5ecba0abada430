"""One score-model training step: noise, forward, loss, backward, NaN skip,
Adam and EMA; and the eval step.

Port of ``confidence_bootstrapping_tpu/train/train_loop.py``
(``make_optimizer``, ``init_train_state``, ``make_train_step``,
``make_eval_step``). PyTorch runs eagerly, so the step is a plain function of
a mutable ``TrainState`` that updates the model, the optimizer and the EMA
copy in place. Two places copy the JAX step's arithmetic rather than a
PyTorch built-in:

* the NaN skip: a step whose loss is not finite zeroes its gradients but
  still runs the Adam update (moments decay, the step count grows, the
  parameters move by the bias-corrected moments) and the EMA, and keeps the
  batch statistics the step started with (``train_loop.py:195-209``);
* gradient clipping is optax's ``clip_by_global_norm``.

Not ported: ``layer_freeze_mask``, ``PlateauScheduler``, ``AverageMeter``,
the torsional step and checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..config import ScoreModelConfig, TrainConfig
from ..data.complex_graph import ComplexBatch
from .diffusion import apply_noise
from .losses import score_matching_loss


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]  # EMA copy of every parameter
    step: int = 0
    lr_scale: float = 1.0  # host-controlled plateau scaling of the learning rate


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
    return TrainState(model, make_optimizer(list(model.parameters()), cfg), ema)


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


@torch.no_grad()
def apply_gradients(state: TrainState, grads, ok, cfg: TrainConfig) -> None:
    """The update half of the step, given each parameter's gradient (None
    counts as zero) and ``ok`` (bool tensor: the loss was finite): NaN skip,
    clipping, Adam or AdamW at lr * lr_scale, EMA with decay
    min(ema_rate, (1 + step) / (10 + step)), step + 1."""
    params = [p for _, p in state.model.named_parameters()]
    grads = [torch.where(ok, g, torch.zeros_like(g)) if g is not None else torch.zeros_like(p)
             for g, p in zip(grads, params)]
    if cfg.grad_clip:
        grads = clip_by_global_norm(grads, cfg.grad_clip)
    for p, g in zip(params, grads):
        p.grad = g
    for group in state.optimizer.param_groups:
        group["lr"] = cfg.lr * state.lr_scale
    state.optimizer.step()
    for p in params:
        p.grad = None
    decay = min(cfg.ema_rate, (1 + state.step) / (10 + state.step))
    for n, p in state.model.named_parameters():
        state.ema[n].mul_(decay).add_(p, alpha=1 - decay)
    state.step += 1


def make_train_step(model_cfg: ScoreModelConfig, cfg: TrainConfig) -> Callable:
    """-> step(state, batch, generator, mark=None) -> metrics (0-d tensors,
    not synchronized). ``mark(name)``, when given, is called after the noise
    and forward ("forward"), after the backward ("backward") and after the
    update ("update"), e.g. to record CUDA events."""

    def step(state: TrainState, batch: ComplexBatch, generator: torch.Generator, mark: Optional[Callable] = None):
        model = state.model
        noised, targets = apply_noise(batch, model_cfg.sigma, cfg, generator, model_cfg.no_torsion)
        saved = batch_stats(model)
        out = model(noised, deterministic=False, use_running_average=False, generator=generator)
        lb = score_matching_loss(out.tr_pred, out.rot_pred, out.tor_pred, targets, noised, model_cfg.sigma,
                                 cfg.tr_weight, cfg.rot_weight, cfg.tor_weight, model_cfg.no_torsion)
        if mark:
            mark("forward")
        params = [p for _, p in model.named_parameters()]
        grads = torch.autograd.grad(lb.loss, params, allow_unused=True)
        if mark:
            mark("backward")
        ok = torch.isfinite(lb.loss)
        apply_gradients(state, grads, ok, cfg)
        keep_batch_stats(model, saved, ok)
        if mark:
            mark("update")
        metrics = {k: v.detach() for k, v in lb._asdict().items()}
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
