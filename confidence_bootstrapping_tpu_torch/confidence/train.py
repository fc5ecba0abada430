"""Confidence-model training.

Port of ``confidence_bootstrapping_tpu/confidence/train.py``: the pose
classification loss (optionally the RMSD regression, binned labels and the
per-atom head's loss), the train and eval steps, accuracy and ROC-AUC
validation, the trajectory sweep and the training loop that keeps the state
of the best validation accuracy.

PyTorch idiom, as in ``train/train_loop.py``: the step is a function of a
mutable ``TrainState`` that trains the model it holds (Adam with the
config's clipping, ``lr_scale``, the NaN skip and the EMA:
``train_loop.apply_gradients``), and dropout draws from an explicit
``torch.Generator``. The train step crops and compacts an all-atom batch
before the forward (``_maybe_compact``), so that the receptor embedding and
the trunk both see the cropped graph, and normalizes with the batch's
statistics; the eval step runs the model deterministically on the running
statistics and leaves them as they were. With ``affinity_prediction`` the
affinity mean squared error joins the objective (``_affinity_terms``: the
residue-level model's affinity column, or the legacy all-atom model's one
affinity per group of ``parallel`` poses).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import SamplerConfig, ScoreModelConfig, TrainConfig
from ..data.complex_graph import replicate_complex
from ..models.all_atom_model import crop_to_caps
from ..runtime import resolve_device
from ..sampler import sampling
from ..train.losses import affinity_loss, atom_confidence_loss, confidence_loss
from ..train.train_loop import AverageMeter, TrainState, apply_gradients, batch_stats, init_train_state, \
    keep_batch_stats


def _normalize_labels(labels):
    """A bare label array or the FilteringDataset labels dict -> a dict with
    at least "y"."""
    if isinstance(labels, dict):
        return labels
    return {"y": labels}


def _label_tensors(labels, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in _normalize_labels(labels).items()}


def _accuracy(pred, y, rmsd_prediction: bool):
    if rmsd_prediction:
        return torch.mean(torch.abs(pred - y))
    if y.ndim >= 2 and y.shape[-1] > 1:  # one-hot bins
        return torch.mean((torch.argmax(pred, -1) == torch.argmax(y, -1)).to(torch.float32))
    return torch.mean(((pred > 0) == (y > 0.5)).to(torch.float32))


def _maybe_compact(model, batch):
    """The batch cropped and compacted before the forward when the all-atom
    model crops (``crop_to_caps``), so that the receptor embedding and the
    trunk both see the cropped graph."""
    return crop_to_caps(model.cfg, batch)[0]


def _affinity_terms(out, labels_d: dict, parallel: int):
    """(the confidence predictions without the affinity, the affinity loss)
    in the model's layout: with ``parallel > 1`` (the legacy all-atom
    model) one affinity per group of ``parallel`` consecutive poses against
    the group's label, every group counted, and the filtering logits [B / P,
    P] as one per pose, [B] in batch order (the JAX package compares them
    unflattened with the [B] labels: the same loss at batch size P, a
    broadcast error above it); otherwise the affinity is the confidence
    head's last column and only poses below the RMSD cutoff
    ("affinity_valid") count. As in the JAX package, the last column is
    taken whatever the model (the all-atom model has no affinity column)."""
    if "affinity" not in labels_d:
        raise ValueError("affinity_prediction requires 'affinity' labels (FilteringDataset(affinities=...))")
    if parallel > 1:
        if out.affinity is None:
            raise ValueError("parallel > 1 requires a model with affinity_prediction=True (legacy all-atom)")
        return out.confidence.reshape(-1), affinity_loss(out.affinity, labels_d["affinity"][::parallel])
    pred = out.confidence
    aff_pred, pred = pred[..., -1], pred[..., :-1]
    if pred.shape[-1] == 1 and labels_d["y"].ndim == 1:
        pred = pred[..., 0]
    return pred, affinity_loss(aff_pred, labels_d["affinity"], labels_d.get("affinity_valid"))


def _losses(out, labels_d: dict, lig_mask, rmsd_prediction: bool, confidence_loss_weight: float,
            atom_confidence_loss_weight: float, require_atom: bool, affinity_prediction: bool = False,
            affinity_loss_weight: float = 1.0, parallel: int = 1):
    """(weighted loss, pose loss, atom loss, affinity loss, the confidence
    predictions) of a forward's output."""
    pred, afloss = (_affinity_terms(out, labels_d, parallel) if affinity_prediction
                    else (out.confidence, None))
    closs = confidence_loss(pred, labels_d["y"], rmsd_prediction)
    afloss = closs.new_zeros(()) if afloss is None else afloss
    aloss = closs.new_zeros(())
    if atom_confidence_loss_weight > 0 and (require_atom or "atom_y" in labels_d):
        if out.atom_confidence is None:
            raise ValueError("atom_confidence_loss_weight > 0 requires a model with atom_confidence=True")
        if "atom_y" not in labels_d:
            raise ValueError("atom_confidence_loss_weight > 0 requires atom_y labels (set atom_label_cutoff)")
        aloss = atom_confidence_loss(out.atom_confidence, labels_d["atom_y"], lig_mask)
    loss = confidence_loss_weight * closs + atom_confidence_loss_weight * aloss + affinity_loss_weight * afloss
    return loss, closs, aloss, afloss, pred


def make_confidence_train_step(model, cfg: TrainConfig, rmsd_prediction: bool = False,
                               confidence_loss_weight: float = 1.0, atom_confidence_loss_weight: float = 0.0,
                               affinity_prediction: bool = False, affinity_loss_weight: float = 1.0,
                               parallel: int = 1) -> Callable:
    """-> step(state, batch, labels, generator, mark=None) -> metrics (0-d
    tensors, not synchronized): loss, confidence_loss, atom_confidence_loss,
    affinity_loss and accuracy. The forward runs with dropout from
    ``generator`` and batch statistics; with ``atom_confidence_loss_weight``
    > 0 the per-atom head trains jointly, with ``affinity_prediction`` the
    affinity (``_affinity_terms``).
    ``mark(name)``, when given, is called after the crop and forward
    ("forward"), after the backward ("backward") and after the update
    ("update"), e.g. to record CUDA events. ``model`` is the state's model
    (its config decides the crop)."""
    def step(state: TrainState, batch, labels, generator: torch.Generator, mark: Optional[Callable] = None):
        m = state.model
        labels_d = _label_tensors(labels, batch.lig_pos.device)
        batch = _maybe_compact(m, batch)
        saved = batch_stats(m)
        out = m(batch, deterministic=False, use_running_average=False, generator=generator)
        loss, closs, aloss, afloss, pred = _losses(out, labels_d, batch.lig_mask, rmsd_prediction,
                                                   confidence_loss_weight, atom_confidence_loss_weight, True,
                                                   affinity_prediction, affinity_loss_weight, parallel)
        if mark:
            mark("forward")
        grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()], allow_unused=True)
        if mark:
            mark("backward")
        ok = torch.isfinite(loss)
        apply_gradients(state, grads, ok, cfg)
        keep_batch_stats(m, saved, ok)
        if mark:
            mark("update")
        return dict(loss=loss.detach(), confidence_loss=closs.detach(), atom_confidence_loss=aloss.detach(),
                    affinity_loss=afloss.detach(), accuracy=_accuracy(pred.detach(), labels_d["y"], rmsd_prediction))

    return step


def make_confidence_eval_step(model, rmsd_prediction: bool = False, atom_confidence_loss_weight: float = 0.0,
                              confidence_loss_weight: float = 1.0, affinity_prediction: bool = False,
                              affinity_loss_weight: float = 1.0, parallel: int = 1) -> Callable:
    """-> eval(state, batch, labels) -> (loss, confidences, affinity loss):
    the deterministic forward on the running statistics, which it leaves as
    they were."""

    @torch.no_grad()
    def step(state: TrainState, batch, labels):
        m = state.model
        labels_d = _label_tensors(labels, batch.lig_pos.device)
        batch = _maybe_compact(m, batch)
        out = m(batch)
        loss, _, _, afloss, pred = _losses(out, labels_d, batch.lig_mask, rmsd_prediction, confidence_loss_weight,
                                           atom_confidence_loss_weight, False, affinity_prediction,
                                           affinity_loss_weight, parallel)
        return loss, pred, afloss

    return step


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC by the rank statistic; nan without both classes."""
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]))
    ranks = np.empty(len(order))
    ranks[order] = np.arange(1, len(order) + 1)
    r_pos = ranks[: len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg)))


def trajectory_sweep(conf_model, score_model, targets, model_cfg: ScoreModelConfig, generator: torch.Generator,
                     inference_steps: int = 20, samples: int = 4, device=None) -> list:
    """The confidence along the reverse diffusion: per denoising step 0..T,
    the accuracy of "confidence > 0" as "pose within 2 A", the mean RMSD and
    the mean confidence, over ``samples`` rollouts of each target (placements
    and noise from ``generator``, on ``device``, default the GPU)."""
    dev = resolve_device(device)
    sampler_cfg = SamplerConfig(inference_steps=inference_steps)
    per_step_scores = [[] for _ in range(inference_steps + 1)]
    per_step_rmsds = [[] for _ in range(inference_steps + 1)]
    for target in targets:
        batch = replicate_complex(target.padded, samples, device=dev)
        batch0 = sampling.randomize_position(batch, generator, model_cfg.sigma.tr_sigma_max)
        _, traj = sampling.sample(score_model, batch0, model_cfg, sampler_cfg, generator, return_trajectory=True,
                                  device=dev)
        L = len(target.hc.lig_f)
        positions = torch.cat([batch0.lig_pos[None], traj], dim=0)
        host = positions[:, :, :L].cpu().numpy()
        for step in range(inference_steps + 1):
            lp = batch.lig_pos.clone()
            lp[:, :L] = positions[step, :, :L]
            scores = sampling.score_confidence(conf_model, batch, lig_pos=lp)
            r = np.sqrt(((host[step] - target.hc.orig_lig_pos[None]) ** 2).sum(-1).mean(-1))
            per_step_scores[step].extend(scores.cpu().numpy().tolist())
            per_step_rmsds[step].extend(r.tolist())
    out = []
    for step in range(inference_steps + 1):
        s = np.asarray(per_step_scores[step])
        r = np.asarray(per_step_rmsds[step])
        out.append(dict(step=step, accuracy=float(np.mean((s > 0) == (r < 2.0))), mean_rmsd=float(r.mean()),
                        mean_score=float(s.mean())))
    return out


def _snapshot(state: TrainState) -> dict:
    """Copies of what a step changes: the model's parameters and buffers, the
    EMA, the optimizer's state and the step count."""
    return dict(model={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                ema={k: v.clone() for k, v in state.ema.items()},
                opt={id_: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
                     for id_, st in state.optimizer.state_dict()["state"].items()},
                step=state.step, lr_scale=state.lr_scale)


@torch.no_grad()
def _restore(state: TrainState, snap: dict) -> None:
    state.model.load_state_dict(snap["model"])
    for k, v in snap["ema"].items():
        state.ema[k].copy_(v)
    sd = state.optimizer.state_dict()
    sd["state"] = snap["opt"]
    state.optimizer.load_state_dict(sd)
    state.step, state.lr_scale = snap["step"], snap["lr_scale"]


def train_confidence(model, dataset, cache, cfg: TrainConfig, n_epochs: int, batches_per_epoch: int,
                     generator: torch.Generator, val_dataset=None, val_cache=None, rmsd_prediction: bool = False,
                     confidence_loss_weight: float = 1.0, atom_confidence_loss_weight: float = 0.0,
                     affinity_prediction: bool = False, affinity_loss_weight: float = 1.0, parallel: int = 1,
                     log: Callable[[str], None] = print):
    """The confidence training loop: (state, history). Each epoch runs
    ``batches_per_epoch`` train steps on ``dataset.sample_batch(cache,
    cfg.batch_size)``; with ``val_dataset`` it then evaluates
    max(1, batches_per_epoch // 4) batches of it (loss, accuracy, ROC-AUC
    and, for trajectory sampling, the accuracy in 21 buckets of the
    diffusion time; with ``affinity_prediction`` the affinity RMSE and the
    predict-the-mean baseline's mean squared error) and the returned state is the one of the best
    validation accuracy (the model, EMA and optimizer put back to it).
    history: one dict per epoch, {"epoch", "train": the step metrics'
    means, "val": ...}."""
    state = init_train_state(model, cfg)
    train_step = make_confidence_train_step(model, cfg, rmsd_prediction, confidence_loss_weight,
                                            atom_confidence_loss_weight, affinity_prediction, affinity_loss_weight,
                                            parallel)
    eval_step = make_confidence_eval_step(model, rmsd_prediction, atom_confidence_loss_weight,
                                          confidence_loss_weight, affinity_prediction, affinity_loss_weight, parallel)
    history = []
    best_acc, best = -np.inf, None
    for epoch in range(n_epochs):
        meter = AverageMeter()
        for _ in range(batches_per_epoch):
            batch, labels = dataset.sample_batch(cache, cfg.batch_size)
            metrics = train_step(state, batch, labels, generator)
            meter.add({k: float(v) for k, v in metrics.items()})
        entry = dict(epoch=epoch, train=meter.summary())

        if val_dataset is not None:
            all_y, all_scores, losses, aflosses, all_affs, all_t = [], [], [], [], [], []
            for _ in range(max(1, batches_per_epoch // 4)):
                batch, labels = val_dataset.sample_batch(val_cache, cfg.batch_size)
                loss, scores, afloss = eval_step(state, batch, labels)
                losses.append(float(loss))
                aflosses.append(float(afloss))
                if affinity_prediction:
                    all_affs.extend(np.asarray(labels["affinity"]).tolist())
                y = labels["y"] if isinstance(labels, dict) else labels
                s = scores.cpu().numpy()
                if y.ndim >= 2 and y.shape[-1] > 1:
                    # binned mode: the binary view is "in the best bin", scored by its logit
                    y, s = y[..., 0], s[..., 0]
                all_y.append(y)
                all_scores.append(s)
                all_t.append(batch.t_tr.cpu().numpy())
            labels_, scores_ = np.concatenate(all_y), np.concatenate(all_scores)
            acc = float(np.mean((scores_ > 0) == (labels_ > 0.5)))
            entry["val"] = dict(loss=float(np.mean(losses)), accuracy=acc, roc_auc=roc_auc(labels_, scores_))
            if getattr(val_dataset, "trajectory_sampling", False):
                t_ = np.concatenate(all_t)
                correct = (scores_ > 0) == (labels_ > 0.5)
                buckets = np.clip((t_ * 20).astype(int), 0, 20)
                entry["val"]["per_t_accuracy"] = [float(correct[buckets == b].mean()) if (buckets == b).any() else None
                                                  for b in range(21)]
            if affinity_prediction:
                a = np.asarray(all_affs)
                entry["val"]["affinity_rmse"] = float(np.sqrt(np.mean(aflosses)))
                entry["val"]["affinity_mean_mse"] = float(((a - a.mean()) ** 2).mean()) if len(a) else 0.0
            if acc > best_acc:
                best_acc, best = acc, (epoch, _snapshot(state))
        history.append(entry)
        log(f"confidence epoch {epoch}: {entry}")
    if best is not None and best[0] != n_epochs - 1:
        _restore(state, best[1])
    return state, history
