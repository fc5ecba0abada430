"""Offline bootstrapping dataset (reference ``bootstrapping/bootstrapping.py``).

Port of ``confidence_bootstrapping_tpu/bootstrapping/offline_dataset.py``:
the cache-or-generate pipeline used by ``train --add_bootstrapping_dataset``
(roll out a frozen score model on target complexes, confidence-filter the
poses, pickle them as ``complexes_id{N}.pkl``), then
confidence-temperature-weighted samples served as extra training complexes.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SamplerConfig, ScoreModelConfig
from ..runtime import resolve_device
from .finetune import keep_poses, pose_confidences, rollout_poses


def generate_bootstrapping_complexes(
    model,
    targets: Sequence,  # CBTarget-like
    generator: torch.Generator,
    model_cfg: ScoreModelConfig,
    samples_per_target: int = 4,
    inference_steps: int = 20,
    confidence_fn: Optional[Callable] = None,
    confidence_cutoff: float = 0.0,
    cache_path: Optional[str] = None,
    cache_id: str = "1",
    device=None,
) -> List[Tuple[dict, str, float]]:
    """Rollout + filter -> [(padded complex @ pose, name, confidence)], on
    ``device`` (default: the GPU), where ``model`` and ``generator`` must be;
    read from ``<cache_path>/complexes_id<cache_id>.pkl`` when it exists,
    written there otherwise. ``confidence_fn`` as in
    ``finetune.inference_epoch``. Only open cache files this repository
    wrote: unpickling runs code."""
    dev = resolve_device(device)
    if cache_path:
        fname = os.path.join(cache_path, f"complexes_id{cache_id}.pkl")
        if os.path.exists(fname):
            with open(fname, "rb") as f:
                return pickle.load(f)

    sampler_cfg = SamplerConfig(inference_steps=inference_steps)
    kept = []
    for target in targets:
        poses = rollout_poses(model, target, samples_per_target, generator, model_cfg, sampler_cfg, dev)
        conf = pose_confidences(confidence_fn, target, poses)
        kept.extend(item for _, item in keep_poses(target, poses.cpu().numpy(), conf, confidence_cutoff))

    if cache_path:
        os.makedirs(cache_path, exist_ok=True)
        with open(fname, "wb") as f:
            pickle.dump(kept, f)
    return kept


class BootstrappingDataset:
    """Serves confidence-temperature-weighted samples from a generated cache
    (reference bootstrapping.py:74-97). Mixable into training via
    CombinedDataset."""

    def __init__(self, complexes: Sequence[Tuple[dict, str, float]], temperature: float = 1.0, multiplicity: int = 1, seed: int = 0):
        self.items = list(complexes)
        self.temperature = temperature
        self.multiplicity = multiplicity
        self.rng = np.random.RandomState(seed)
        conf = np.asarray([c for _, _, c in self.items], dtype=np.float64)
        w = np.exp(conf * temperature)
        self.weights = w / w.sum() if len(w) else w

    def __len__(self):
        return len(self.items) * self.multiplicity

    def get(self, idx: int) -> dict:
        i = self.rng.choice(len(self.items), p=self.weights)
        return dict(self.items[i][0])
