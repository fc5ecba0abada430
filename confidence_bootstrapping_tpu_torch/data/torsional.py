"""Torsional-diffusion pretraining data (``train --dataset torsional``).

Port of ``confidence_bootstrapping_tpu/data/torsional.py`` (the reference's
``datasets/torsional.py``): small molecules from a directory of SDFs, each as
a padded complex with a one-residue dummy receptor (N=1, KR=1) so the shared
batch and model code applies; noise that perturbs only the torsion angles,
with targets from the torus score table; and the torsion-only loss.

``torsional_apply_noise`` is split, as ``train.diffusion.apply_noise`` is,
into ``torsional_draw_noise`` (every random number, from one
``torch.Generator``) and ``torsional_apply_draws`` (the rest,
deterministic), so a test can hand the port the JAX package's draws.
Batches land on the dataset's device (default: the GPU).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import torus
from ..ops.schedules import SigmaParams, t_to_sigma
from ..ops.torsion import apply_torsion_updates
from ..parallel.mesh import psum
from ..train.diffusion import ScoreTargets, sample_train_times
from .complex_graph import ComplexBatch, HostComplex, batch_complexes, pad_complex, pick_bucket
from .featurize import featurize_ligand, get_transformation_mask
from .mol_io import parse_sdf


class TorsionalDraws(NamedTuple):
    t: torch.Tensor  # [B] diffusion time
    tor_updates: torch.Tensor  # [B, R] radians, scaled by sigma_tor, zero on padded slots


def torsional_draw_noise(batch: ComplexBatch, sigma: SigmaParams, cfg: TrainConfig,
                         generator: torch.Generator) -> TorsionalDraws:
    """t ~ the training schedule, then N(0, sigma_tor(t)) torsion updates on
    the valid torsion slots."""
    B, dev = batch.batch_size, batch.lig_pos.device
    R = batch.tor_src.shape[1]
    t = sample_train_times(B, cfg, generator, dev)
    tor_sigma = t_to_sigma(t, t, t, sigma)[2]
    updates = torch.randn((B, R), generator=generator, device=dev) * tor_sigma[:, None]
    return TorsionalDraws(t, torch.where(batch.tor_mask, updates, torch.zeros_like(updates)))


def torsional_apply_draws(batch: ComplexBatch, draws: TorsionalDraws, sigma: SigmaParams):
    """(noised batch, targets): the torsion angles turned by the draws; zero
    translation and rotation targets, torsion targets from the torus table."""
    t, updates = draws
    batch = batch.set_time(t, t, t)
    tor_sigma = t_to_sigma(t, t, t, sigma)[2]
    new_pos = apply_torsion_updates(batch.lig_pos, batch.tor_src, batch.tor_dst, batch.mask_rotate, updates,
                                    batch.tor_mask)
    tor_score = torch.where(batch.tor_mask, torus.score(updates, tor_sigma[:, None]), torch.zeros_like(updates))
    zeros = updates.new_zeros(batch.batch_size, 3)
    return batch.replace(lig_pos=new_pos), ScoreTargets(zeros, zeros, tor_score, tor_sigma)


def torsional_apply_noise(batch: ComplexBatch, sigma: SigmaParams, cfg: TrainConfig, generator: torch.Generator):
    """Perturb only the torsion angles of a clean batch: (noised batch, targets)."""
    return torsional_apply_draws(batch, torsional_draw_noise(batch, sigma, cfg, generator), sigma)


def torsional_loss(tor_pred, targets: ScoreTargets, batch: ComplexBatch):
    """The torsion-only score-matching loss and the zero predictor's
    (reference training.py:129-149): squared error over E[score^2], masked
    mean over the valid torsion slots."""
    norm2 = torus.score_norm(targets.tor_sigma)[:, None]
    m = batch.tor_mask.to(tor_pred.dtype)
    per_edge = (tor_pred - targets.tor_score) ** 2 / norm2 * m
    base = targets.tor_score ** 2 / norm2 * m
    cnt = torch.clamp(psum(torch.sum(m)), min=1.0)  # global under parallel.mesh.data_parallel
    return torch.sum(per_edge) / cnt, torch.sum(base) / cnt


class TorsionalDataset:
    """Small molecules (no receptor) as padded complexes with a dummy
    single-residue receptor. Molecules without a rotatable bond or with
    fewer than 4 heavy atoms are left out, as are files that do not parse
    (printed)."""

    def __init__(self, data_dir: str, limit: int = 0, split_idx: Optional[np.ndarray] = None, device=None):
        self.device = device  # where epoch_batches puts its batches (None: the GPU)
        self.complexes: List[HostComplex] = []
        files = sorted(f for f in os.listdir(data_dir) if f.endswith((".sdf", ".mol")))
        if split_idx is not None:
            files = [files[i] for i in split_idx if i < len(files)]
        if limit:
            files = files[:limit]
        for f in files:
            try:
                mol = parse_sdf(os.path.join(data_dir, f))
                feats, heavy, src, dst, attr = featurize_ligand(mol)
                tor_src, tor_dst, mask_rotate = get_transformation_mask(heavy.num_atoms, heavy.bonds)
                if len(tor_src) == 0 or heavy.num_atoms < 4:
                    continue
                center = heavy.pos.mean(0)
                self.complexes.append(HostComplex(
                    name=f[:-4],
                    lig_f=feats,
                    lig_pos=(heavy.pos - center).astype(np.float32),
                    lig_edge_src=src,
                    lig_edge_dst=dst,
                    lig_edge_attr=attr,
                    tor_src=tor_src,
                    tor_dst=tor_dst,
                    mask_rotate=mask_rotate,
                    rec_f=np.zeros(1, dtype=np.int32),
                    rec_lm=np.zeros((1, 0), dtype=np.float32),
                    rec_pos=np.zeros((1, 3), dtype=np.float32),
                    rec_nbr=np.zeros((1, 1), dtype=np.int32),
                    rec_nbr_mask=np.zeros((1, 1), dtype=bool),
                    orig_center=center.astype(np.float32),
                    orig_lig_pos=(heavy.pos - center).astype(np.float32),
                ))
            except Exception as e:
                print(f"torsional: skipping {f}: {type(e).__name__}: {e}")

    def __len__(self):
        return len(self.complexes)

    def epoch_batches(self, batch_size: int, rng: np.random.RandomState, lm_dim: int = 0):
        """Shuffled batches, one ligand bucket each (the receptor cut to
        N=1, KR=1); a short group repeats its items to fill the batch. The
        same draws from ``rng`` as the JAX package's, so the same order."""
        groups = {}
        for hc in self.complexes:
            b = pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), 1)
            groups.setdefault(tuple(b), []).append(pad_complex(hc, b._replace(N=1, KR=1), lm_dim=lm_dim))
        batches = []
        for items in groups.values():
            idx = rng.permutation(len(items))
            for s in range(0, len(items), batch_size):
                sel = [items[i] for i in idx[s: s + batch_size]]
                while len(sel) < batch_size:
                    sel.append(sel[len(sel) % max(1, len(idx[s: s + batch_size]))])
                batches.append(batch_complexes(sel, self.device))
        rng.shuffle(batches)
        return batches
