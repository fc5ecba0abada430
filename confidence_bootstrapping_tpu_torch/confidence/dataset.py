"""Confidence-model datasets: score-model rollouts with RMSD labels.

Port of ``confidence_bootstrapping_tpu/confidence/dataset.py``:

* ``generate_filtering_cache``: roll out the frozen score model for
  ``samples_per_complex`` poses per complex and record (positions, RMSDs of
  the final poses) by complex name, cached in a pickle of numpy arrays whose
  name holds the generation parameters (``filtering_cache_name``), so that
  either package reads the other's cache; ``combine_caches`` merges caches;
* ``FilteringDataset``: batches of the complexes at cached poses with the
  label y = RMSD < cutoff (or one-hot RMSD bins, or the RMSD itself),
  balanced sampling, the band between the cutoff and
  ``rmsd_classification_upper`` left out, per-atom labels, trajectory
  frames with their diffusion times, and ``parallel`` poses of one complex
  in a row. Its picks come from ``np.random.RandomState(seed)``, drawn as the
  JAX package draws them, so the same seed gives the same batches;
* ``PerturbationFilteringDataset``: labels from forward-diffusion
  perturbations (``train/diffusion.apply_noise``).

The RMSD is the plain heavy-atom RMSD, as in the JAX package. Randomness of
the rollouts and perturbations comes from a ``torch.Generator``; batches are
made on the dataset's ``device`` (default: the GPU). With ``affinities``
({complex name: affinity}) each batch also carries the affinity labels and
their validity (the pose below the RMSD cutoff).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SamplerConfig, ScoreModelConfig, TrainConfig
from ..data.complex_graph import batch_complexes, replicate_complex
from ..runtime import resolve_device
from ..sampler import sampling
from ..train.diffusion import apply_noise


def filtering_cache_name(cache_id: str, samples_per_complex: int, inference_steps: int, trajectory: bool) -> str:
    """The cache file's name, keyed by the generation parameters, so that a
    change of any of them never reuses a stale cache."""
    return (f"confidence_cache_id{cache_id}_s{samples_per_complex}_T{inference_steps}"
            + ("_traj" if trajectory else "") + ".pkl")


def generate_filtering_cache(model, targets: Sequence, generator: torch.Generator, model_cfg: ScoreModelConfig,
                             samples_per_complex: int = 4, inference_steps: int = 20, cache_path: Optional[str] = None,
                             cache_id: str = "1", trajectory: bool = False,
                             device=None) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """-> {name: (positions, rmsds [s])}, cached to a pickle in
    ``cache_path`` (read back when it exists).

    ``targets``: objects with ``.padded``, ``.hc`` and ``.name``
    (``bootstrapping.finetune.CBTarget``). Per target, ``samples_per_complex``
    random placements (``sampling.randomize_position``) are denoised by
    ``model`` over ``inference_steps`` steps (``sampling.sample``), both
    drawing from ``generator``, on ``device`` (default: the GPU). positions
    is [s, L, 3] (the final poses) or, with ``trajectory``, the whole reverse
    diffusion [steps + 1, s, L, 3] from the start to the final poses; the
    RMSDs are always the final poses' (every frame of a trajectory carries
    its final label)."""
    if cache_path:
        fname = os.path.join(cache_path, filtering_cache_name(cache_id, samples_per_complex, inference_steps,
                                                                trajectory))
        if os.path.exists(fname):
            with open(fname, "rb") as f:
                return pickle.load(f)
    dev = resolve_device(device)
    sampler_cfg = SamplerConfig(inference_steps=inference_steps)
    out = {}
    for target in targets:
        batch = replicate_complex(target.padded, samples_per_complex, device=dev)
        batch = sampling.randomize_position(batch, generator, model_cfg.sigma.tr_sigma_max)
        final, traj = sampling.sample(model, batch, model_cfg, sampler_cfg, generator, return_trajectory=trajectory,
                                      device=dev)
        L = len(target.hc.lig_f)
        poses = final.lig_pos[:, :L].cpu().numpy()
        rmsds = np.sqrt(((poses - target.hc.orig_lig_pos[None]) ** 2).sum(-1).mean(-1))
        if trajectory:
            frames = torch.cat([batch.lig_pos[None, :, :L], traj[:, :, :L]], dim=0).cpu().numpy()
            out[target.name] = (frames, rmsds)
        else:
            out[target.name] = (poses, rmsds)
    if cache_path:
        os.makedirs(cache_path, exist_ok=True)
        with open(fname, "wb") as f:
            pickle.dump(out, f)
    return out


def binned_labels(rmsds: np.ndarray, cutoffs: Sequence[float]) -> np.ndarray:
    """One-hot RMSD bins [n, len(cutoffs) + 1]: bin k holds
    cutoffs[k-1] <= r < cutoffs[k], the first r < cutoffs[0], the last
    r >= cutoffs[-1]."""
    edges = np.concatenate([[0.0], np.asarray(cutoffs, dtype=np.float64), [np.inf]])
    r = np.asarray(rmsds, dtype=np.float64)[..., None]
    return np.logical_and(r < edges[1:], r >= edges[:-1]).astype(np.float32)


def combine_caches(caches: Sequence[Dict]) -> Dict:
    """Merge generation caches: the poses and RMSDs of a complex in several
    caches are concatenated in the caches' order."""
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for c in caches:
        for name, (pos, rmsds) in c.items():
            if name in out:
                out[name] = (np.concatenate([out[name][0], pos]), np.concatenate([out[name][1], rmsds]))
            else:
                out[name] = (pos, rmsds)
    return out


class FilteringDataset:
    """Pose-classification dataset over a generation cache.

    ``rmsd_classification_cutoff`` may be a list of cutoffs: the labels are
    then one-hot RMSD bins (the pose loss a cross-entropy). With
    ``atom_label_cutoff`` each item also carries per-atom labels: the
    distance of each atom of the pose to the crystal pose, thresholded
    (a float gives binary labels, a list bins). ``trajectory_sampling`` draws
    a random frame of a trajectory cache per item and stamps its diffusion
    time on the batch; the label stays the final pose's. ``parallel`` > 1:
    each group of ``parallel`` consecutive items is ``parallel`` distinct
    poses of one complex, drawn without replacement. ``affinities``:
    {complex name: binding affinity} (0 for a complex it lacks). Batches
    are made on ``device`` (default: the GPU)."""

    def __init__(self, targets: Sequence, cache: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 rmsd_classification_cutoff=2.0, rmsd_classification_upper: Optional[float] = 4.0,
                 balance: bool = True, rmsd_prediction: bool = False, seed: int = 0, atom_label_cutoff=None,
                 trajectory_sampling: bool = False, affinities: Optional[Dict[str, float]] = None, parallel: int = 1,
                 device=None):
        self.targets = {t.name: t for t in targets}
        self.rng = np.random.RandomState(seed)
        self.binned = isinstance(rmsd_classification_cutoff, (list, tuple))
        if self.binned and balance:
            raise ValueError("a cutoff list cannot be combined with balance")
        self.cutoffs = list(rmsd_classification_cutoff) if self.binned else None
        self.cutoff = self.cutoffs[0] if self.binned else float(rmsd_classification_cutoff)
        self.upper = rmsd_classification_upper
        self.balance = balance
        self.rmsd_prediction = rmsd_prediction
        self.atom_label_cutoff = atom_label_cutoff
        self.atom_binned = isinstance(atom_label_cutoff, (list, tuple))
        self.trajectory_sampling = trajectory_sampling
        self.affinities = affinities
        self.parallel = int(parallel)
        self.device = resolve_device(device)

        self.entries: List[Tuple[str, int, float]] = []  # (name, pose index, final RMSD)
        for name, (_, rmsds) in cache.items():
            if name not in self.targets:
                continue
            for i, r in enumerate(rmsds):
                if self.upper is not None and self.cutoff < r < self.upper and not (rmsd_prediction or self.binned):
                    continue  # the ambiguous band is left out of training
                self.entries.append((name, i, float(r)))
        self.positives = [e for e in self.entries if e[2] < self.cutoff]
        self.negatives = [e for e in self.entries if e[2] >= self.cutoff]

    def __len__(self):
        return len(self.entries)

    def sample_entry(self):
        if self.balance and self.positives and self.negatives:
            pool = self.positives if self.rng.rand() < 0.5 else self.negatives
        else:
            pool = self.entries
        return pool[self.rng.randint(len(pool))]

    def _pose_and_time(self, cache_positions: np.ndarray, i: int):
        """-> (pose [L, 3], diffusion time t). A trajectory cache is
        [frames, s, L, 3] from the start to the final poses; frame f has
        t = 1 - f / (frames - 1)."""
        if self.trajectory_sampling:
            if cache_positions.ndim != 4:
                raise ValueError("trajectory_sampling requires a trajectory cache (generate with trajectory=True)")
            frames = cache_positions.shape[0]
            f = self.rng.randint(frames)
            return cache_positions[f, i], 1.0 - f / max(frames - 1, 1)
        return cache_positions[i], 0.0

    def sample_batch(self, cache, batch_size: int):
        """-> (ComplexBatch at the sampled poses with their times, labels).

        labels is a dict of numpy arrays: "y" ([b] float, or one-hot
        [b, nbins] in binned mode) and "rmsd" [b]; with
        ``atom_label_cutoff`` also "atom_y" ([b, L_pad] binary or
        [b, L_pad, nbins] one-hot; padded atoms 0); with ``affinities`` also
        "affinity" [b] and "affinity_valid" [b] (1 where the pose's RMSD is
        below the cutoff: only those carry the combined head's affinity
        loss)."""
        picks: List[Tuple[str, int, float]] = []
        if self.parallel > 1:
            if batch_size % self.parallel:
                raise ValueError(f"batch_size {batch_size} not divisible by parallel {self.parallel}")
            for _ in range(batch_size // self.parallel):
                name, _, _ = self.sample_entry()
                rs = cache[name][1]
                if self.parallel > len(rs):
                    raise ValueError("parallel size larger than sample size")
                idxs = (np.arange(self.parallel) if self.parallel == len(rs)
                        else self.rng.choice(len(rs), size=self.parallel, replace=False))
                picks.extend((name, int(i), float(rs[i])) for i in idxs)
        else:
            picks = [self.sample_entry() for _ in range(batch_size)]

        items, ys, rmsds, atom_ys, times, affs = [], [], [], [], [], []
        for name, i, r in picks:
            target = self.targets[name]
            pos, _ = cache[name]
            item = dict(target.padded)
            pose, t = self._pose_and_time(pos, i)
            L = pose.shape[0]
            lig_pos = item["lig_pos"].copy()
            lig_pos[:L] = pose
            item["lig_pos"] = lig_pos
            items.append(item)
            times.append(t)
            rmsds.append(r)
            if self.rmsd_prediction:
                ys.append(r)
            elif self.binned:
                ys.append(binned_labels(np.asarray([r]), self.cutoffs)[0])
            else:
                ys.append(float(r < self.cutoff))
            if self.atom_label_cutoff is not None:
                d = np.zeros(item["lig_pos"].shape[0], dtype=np.float32)
                d[:L] = np.linalg.norm(pose - target.hc.orig_lig_pos, axis=-1)
                if self.atom_binned:
                    atom_ys.append(binned_labels(d, list(self.atom_label_cutoff)))
                else:
                    atom_ys.append((d < float(self.atom_label_cutoff)).astype(np.float32))
            if self.affinities is not None:
                affs.append(float(self.affinities.get(name, 0.0)))
        batch = batch_complexes(items, self.device)
        tvec = torch.as_tensor(np.asarray(times, dtype=np.float32), device=self.device)
        batch = batch.replace(t_tr=tvec, t_rot=tvec, t_tor=tvec)
        labels = dict(y=np.asarray(ys, dtype=np.float32), rmsd=np.asarray(rmsds, dtype=np.float32))
        if self.atom_label_cutoff is not None:
            labels["atom_y"] = np.stack(atom_ys)
        if self.affinities is not None:
            labels["affinity"] = np.asarray(affs, dtype=np.float32)
            labels["affinity_valid"] = (labels["rmsd"] < self.cutoff).astype(np.float32)
        return batch, labels

    def statistics(self):
        rmsds = np.asarray([e[2] for e in self.entries])
        return dict(n=len(self.entries), positives=len(self.positives), negatives=len(self.negatives),
                    mean_rmsd=float(rmsds.mean()) if len(rmsds) else 0.0)


class PerturbationFilteringDataset:
    """Labels from forward-diffusion perturbations at random times: a
    perturbed pose is positive when its RMSD to the crystal pose is below
    ``rmsd_cutoff``. Batches are made on ``device`` (default: the GPU)."""

    def __init__(self, targets: Sequence, model_cfg: ScoreModelConfig, rmsd_cutoff: float = 2.0, alpha=1.0,
                 beta=1.0, device=None):
        self.targets = list(targets)
        self.model_cfg = model_cfg
        self.rmsd_cutoff = rmsd_cutoff
        self.tcfg = TrainConfig(sampling_alpha=alpha, sampling_beta=beta)
        self.device = resolve_device(device)

    def sample_batch(self, generator: torch.Generator, batch_size: int, rng: np.random.RandomState):
        """-> (the perturbed batch at t = 0, labels [b] numpy): complexes
        picked by ``rng``, the noise drawn from ``generator``."""
        idx = rng.randint(len(self.targets), size=batch_size)
        batch = batch_complexes([dict(self.targets[i].padded) for i in idx], self.device)
        noised, _ = apply_noise(batch, self.model_cfg.sigma, self.tcfg, generator)
        d = (noised.lig_pos - batch.lig_pos).cpu().numpy()
        mask = batch.lig_mask.cpu().numpy()
        rmsds = np.sqrt((d ** 2).sum(-1).sum(-1) / np.maximum(mask.sum(-1), 1))
        labels = (rmsds < self.rmsd_cutoff).astype(np.float32)
        return noised.set_time(0.0, 0.0, 0.0), labels
