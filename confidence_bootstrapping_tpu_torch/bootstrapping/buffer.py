"""Replay buffer of self-generated complexes (reference bootstrapping/buffer.py).

Port of ``confidence_bootstrapping_tpu/bootstrapping/buffer.py``: the same
numpy logic line for line, so the same calls give the same picks from the
same ``np.random.RandomState(0)``.

Holds padded host complexes (numpy dicts) whose ligand positions are sampled
poses, stamped with the confidence and the rollout iteration:

  * confidence-weighted sampling with temperature when ``fixed_length`` is
    set (reference :37-45);
  * per-receptor cap ``max_complexes_per_couple`` ranked by
    confidence + buffer_decay * iteration (reference :96-114);
  * ``reset_buffer`` drops old rollouts each iteration.

Items already carry t=0 (the CB finetune applies its own NoiseTransform).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class BufferItem:
    padded: dict  # padded complex arrays (lig_pos = sampled pose)
    name: str
    confidence: float
    iteration: int


@dataclass
class CBBuffer:
    cluster_ligands: Sequence[str] = ()
    multiplicity: int = 1
    max_complexes_per_couple: Optional[int] = None
    fixed_length: Optional[int] = None
    temperature: float = 1.0
    buffer_decay: float = 0.2
    reset_buffer: bool = False
    rng: np.random.RandomState = field(default_factory=lambda: np.random.RandomState(0))

    def __post_init__(self):
        self.complexes: List[BufferItem] = []
        self.iteration = 0
        self.ligand_cnt: Dict[str, int] = {name: 0 for name in self.cluster_ligands}

    def __len__(self):
        if self.fixed_length is None:
            return len(self.complexes) * self.multiplicity
        return self.fixed_length

    def get(self, idx: int) -> dict:
        """Serve one padded complex.

        In fixed-length mode ``idx`` is intentionally ignored: every access
        draws confidence-weighted with temperature (reference buffer.py
        samples by softmax(conf * T) too), so one "epoch" CAN resample
        duplicates — that is the CB algorithm's behavior, not a bug.

        The returned dict is a fresh container but shares the (read-only)
        numpy arrays — consumers stack them into device batches and never
        write in place, so the former per-item deepcopy of ~MB-scale arrays
        was pure overhead.
        """
        if self.fixed_length is None:
            item = self.complexes[idx % len(self.complexes)]
        else:
            conf = np.asarray([c.confidence for c in self.complexes])
            w = np.exp(conf * self.temperature)
            item = self.complexes[self.rng.choice(len(self.complexes), p=w / w.sum())]
        return dict(item.padded)

    def sample_batch(self, batch_size: int) -> List[dict]:
        """One SINGLE-BUCKET training batch.

        Device batches must stack same-shape arrays, but a CB cluster's
        complexes can land in different padding buckets (the reference has
        no buckets — dynamic PyG graphs batch freely). Pick a bucket with
        probability proportional to its items' total sampling weight, then
        draw the whole batch within it: distributionally the same
        confidence-weighted sampling, restricted per batch (alternating
        across batches) instead of per item.
        """
        if not self.complexes:
            return []
        buckets: Dict[tuple, List[int]] = {}
        for i, it in enumerate(self.complexes):
            buckets.setdefault(self._bucket_key(it.padded), []).append(i)
        if len(buckets) == 1:
            return [self.get(i) for i in range(batch_size)]
        conf = np.asarray([c.confidence for c in self.complexes])
        w = np.exp((conf - conf.max()) * self.temperature)
        keys = list(buckets.keys())
        bw = np.asarray([w[buckets[k]].sum() for k in keys])
        key = keys[self.rng.choice(len(keys), p=bw / bw.sum())]
        idxs = buckets[key]
        if self.fixed_length is None:
            picks = [idxs[i % len(idxs)] for i in range(batch_size)]
        else:
            ww = w[idxs] / w[idxs].sum()
            picks = self.rng.choice(idxs, size=batch_size, p=ww)
        return [dict(self.complexes[i].padded) for i in picks]

    @staticmethod
    def _bucket_key(padded: dict) -> tuple:
        return tuple(np.asarray(v).shape for v in padded.values() if hasattr(v, "shape"))

    def add_complexes(self, new_items: Sequence[Tuple[dict, str, float]]):
        """new_items: (padded complex with sampled pose, name, confidence)."""
        fresh = [BufferItem(p, n, float(c), self.iteration) for p, n, c in new_items]
        for item in fresh:
            self.ligand_cnt[item.name] = self.ligand_cnt.get(item.name, 0) + 1
        self.complexes = fresh if self.reset_buffer else self.complexes + fresh
        self.iteration += 1

        if self.max_complexes_per_couple is not None:
            by_receptor: Dict[str, List[BufferItem]] = {}
            for item in self.complexes:
                by_receptor.setdefault(item.name[:6], []).append(item)
            kept = []
            for items in by_receptor.values():
                items.sort(key=lambda it: it.confidence + self.buffer_decay * it.iteration, reverse=True)
                kept.extend(items[: self.max_complexes_per_couple])
            self.complexes = kept

    def statistics(self) -> dict:
        return dict(
            size=len(self.complexes),
            iteration=self.iteration,
            mean_confidence=float(np.mean([c.confidence for c in self.complexes])) if self.complexes else 0.0,
            ligand_counts=dict(self.ligand_cnt),
        )
