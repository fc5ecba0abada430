"""Reverse diffusion on T(3) x SO(3) x T^m.

Port of ``confidence_bootstrapping_tpu/sampler/sampling.py`` for the serving
path: ``randomize_position``, ``make_schedules``, ``reverse_diffusion_step``,
the shared receptor embedding, phased receptor compaction
(``_phase_plan``/``_compact_receptor``) and ``sample``. The ``lax.scan`` is a
Python loop and the ``lax.cond`` a Python branch. Randomness comes from an
explicit ``torch.Generator``; a step can instead take the noise tensors
(``tr_z``, ``rot_z``, ``tor_z``), so a test can feed the exact noise that
JAX's threefry drew. ``score_confidence`` scores poses with the all-atom
confidence model (crop and compaction per pose, or a shared receptor
embedding). SVGD, ``derive_phase_plan`` and ``score_confidence``'s
``embed_full_receptor`` option are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SamplerConfig, ScoreModelConfig
from ..data.complex_graph import ComplexBatch
from ..models.all_atom_model import compact_crop
from ..ops.geometry import quaternion_to_matrix
from ..ops.graph_builders import pairwise_dist
from ..ops.poses import modify_conformer
from ..ops.schedules import get_t_schedule, t_to_sigma
from ..ops.torsion import apply_torsion_updates
from ..runtime import resolve_device


def uniform_rotation(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """n uniform random rotation matrices via normalized quaternions."""
    q = torch.randn(n, 4, generator=generator, device=device)
    return quaternion_to_matrix(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def randomize_position(batch: ComplexBatch, generator: torch.Generator, tr_sigma_max: float,
                       no_torsion: bool = False, no_random: bool = False,
                       initial_noise_std_proportion: float = 1.0) -> ComplexBatch:
    """Random torsions, orientation and position around the receptor center
    (the t=1 prior). Draws torsions, then rotations, then the translation."""
    B = batch.batch_size
    dev = batch.lig_pos.device
    pos = batch.lig_pos
    if not no_torsion:
        u = torch.rand(batch.tor_src.shape, generator=generator, device=dev) * (2 * math.pi) - math.pi
        pos = apply_torsion_updates(pos, batch.tor_src, batch.tor_dst, batch.mask_rotate, u, batch.tor_mask)
    m = batch.lig_mask.to(pos.dtype)[..., None]
    center = torch.sum(pos * m, dim=1, keepdim=True) / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    rot = uniform_rotation(generator, B, dev)
    rm = batch.rec_mask.to(pos.dtype)[..., None]
    pocket = torch.sum(batch.rec_pos * rm, dim=1) / torch.clamp(torch.sum(rm, dim=1), min=1.0)
    pos = torch.einsum("bld,bed->ble", pos - center, rot) + pocket[:, None, :]
    if not no_random:
        tr = torch.randn(B, 3, generator=generator, device=dev) * tr_sigma_max * initial_noise_std_proportion
        pos = pos + tr[:, None, :]
    return batch.replace(lig_pos=pos)


class Schedules(NamedTuple):
    t_tr: np.ndarray  # [steps] float32
    t_rot: np.ndarray
    t_tor: np.ndarray
    dt_tr: np.ndarray
    dt_rot: np.ndarray
    dt_tor: np.ndarray


def num_steps(cfg: SamplerConfig) -> int:
    """Steps actually executed (the first actual_steps of the schedule)."""
    return int(cfg.actual_steps) if cfg.actual_steps else int(cfg.inference_steps)


def make_schedules(cfg: SamplerConfig) -> Schedules:
    t = get_t_schedule(cfg.inference_steps, cfg.sigma_schedule, cfg.inf_sched_alpha, cfg.inf_sched_beta,
                       t_max=cfg.t_max)[: num_steps(cfg)]
    dt = (t - np.concatenate([t[1:], np.zeros(1, np.float32)])).astype(np.float32)
    return Schedules(t, t, t, dt, dt, dt)


def _g(sigma, smax: float, smin: float):
    return sigma * math.sqrt(2 * math.log(smax / smin))


def reverse_diffusion_step(model, batch: ComplexBatch, rec_cache, step_idx: int, sched: Schedules,
                           model_cfg: ScoreModelConfig, cfg: SamplerConfig,
                           generator: Optional[torch.Generator] = None,
                           tr_z=None, rot_z=None, tor_z=None) -> ComplexBatch:
    """One Euler-Maruyama (or probability-flow ODE) step. The noise is drawn
    from ``generator`` (tr, rot, tor in that order) unless it is given."""
    B, dev = batch.batch_size, batch.lig_pos.device
    sp = model_cfg.sigma

    def scalar(a):
        return torch.tensor(float(a[step_idx]), dtype=torch.float32, device=dev)

    t_tr, t_rot, t_tor = scalar(sched.t_tr), scalar(sched.t_rot), scalar(sched.t_tor)
    dt_tr, dt_rot, dt_tor = scalar(sched.dt_tr), scalar(sched.dt_rot), scalar(sched.dt_tor)
    tr_sigma, rot_sigma, tor_sigma = t_to_sigma(t_tr, t_rot, t_tor, sp)

    out = model(batch.set_time(t_tr, t_rot, t_tor), rec_cache=rec_cache)
    tr_score, rot_score, tor_score = out.tr_pred, out.rot_pred, out.tor_pred

    tr_g = _g(tr_sigma, sp.tr_sigma_max, sp.tr_sigma_min)
    rot_g = _g(rot_sigma, sp.rot_sigma_max, sp.rot_sigma_min)
    tor_g = _g(tor_sigma, sp.tor_sigma_max, sp.tor_sigma_min)

    if tr_z is None:
        tr_z = torch.randn(B, 3, generator=generator, device=dev)
        rot_z = torch.randn(B, 3, generator=generator, device=dev)
        tor_z = torch.randn(tor_score.shape, generator=generator, device=dev)
    last = step_idx == num_steps(cfg) - 1
    if cfg.no_random or (cfg.no_final_step_noise and last):
        tr_z, rot_z, tor_z = tr_z * 0.0, rot_z * 0.0, tor_z * 0.0

    if cfg.ode:
        tr_perturb = 0.5 * tr_g**2 * dt_tr * tr_score
        rot_perturb = 0.5 * rot_g**2 * dt_rot * rot_score
        tor_perturb = 0.5 * tor_g**2 * dt_tor * tor_score
    else:
        # low-temperature sampling algebra; the identity at temp=1, psi=0
        def lam(sd_max, sd_min, sigma, temp):
            sigma_data = math.exp(cfg.temp_sigma_data * math.log(sd_max) + (1 - cfg.temp_sigma_data) * math.log(sd_min))
            return (sigma_data + sigma) / (sigma_data + sigma / temp)

        t0, t1, t2 = cfg.temp_sampling
        p0, p1, p2 = cfg.temp_psi
        lam_tr = lam(sp.tr_sigma_max, sp.tr_sigma_min, tr_sigma, t0)
        lam_rot = lam(sp.rot_sigma_max, sp.rot_sigma_min, rot_sigma, t1)
        lam_tor = lam(sp.tor_sigma_max, sp.tor_sigma_min, tor_sigma, t2)
        tr_perturb = tr_g**2 * dt_tr * (lam_tr + t0 * p0 / 2) * tr_score + tr_g * torch.sqrt(dt_tr * (1 + p0)) * tr_z
        rot_perturb = rot_g**2 * dt_rot * (lam_rot + t1 * p1 / 2) * rot_score + rot_g * torch.sqrt(dt_rot * (1 + p1)) * rot_z
        tor_perturb = tor_g**2 * dt_tor * (lam_tor + t2 * p2 / 2) * tor_score + tor_g * torch.sqrt(dt_tor * (1 + p2)) * tor_z

    new_pos = modify_conformer(batch.lig_pos, batch.lig_mask, tr_perturb, rot_perturb,
                               None if model_cfg.no_torsion else tor_perturb,
                               batch.tor_src, batch.tor_dst, batch.mask_rotate, batch.tor_mask)
    return batch.replace(lig_pos=new_pos)


def _compact_receptor(batch: ComplexBatch, rec_cache, radius, cap: int):
    """Shrink the receptor view to the ``cap`` residues nearest any pose's
    ligand among those within ``radius`` of one: one index set for the whole
    pose batch. Remaps the kNN lists and gathers the cached embeddings; slots
    left empty are masked out and their cached rows zeroed, as in the JAX
    package. Returns (batch, rec_cache) with N = cap."""
    B, N = batch.rec_mask.shape
    cap = min(cap, N)
    dev = batch.rec_pos.device
    inf = torch.tensor(float("inf"), device=dev)
    d = torch.where(batch.lig_mask[:, :, None], pairwise_dist(batch.lig_pos, batch.rec_pos), inf).amin(dim=1)
    pri = torch.where(batch.rec_mask & (d < radius), d, inf).amin(dim=0)  # [N] shared over poses
    idx = torch.argsort(pri, stable=True)[:cap]
    selected = pri[idx] < inf
    new_of_old = torch.full((N,), -1, dtype=torch.int64, device=dev)
    new_of_old[idx] = torch.where(selected, torch.arange(cap, device=dev), -1)

    def take(a):
        return a.index_select(1, idx)

    def take_rows(a):  # float rows of empty slots are zero
        t = take(a)
        return t * selected.view((1, cap) + (1,) * (t.dim() - 2)).to(t.dtype)

    valid = take(batch.rec_mask) & selected[None, :]
    nbr_new = new_of_old[take(batch.rec_nbr)]
    nbr_mask = take(batch.rec_nbr_mask) & (nbr_new >= 0) & valid[..., None]
    new_batch = batch.replace(
        rec_f=take(batch.rec_f),
        rec_lm=take(batch.rec_lm),  # read only by embed_receptor, before any compaction
        rec_pos=take(batch.rec_pos),
        rec_mask=valid,
        rec_nbr=torch.clamp(nbr_new, min=0),
        rec_nbr_mask=nbr_mask,
    )
    new_cache = None
    if rec_cache is not None:
        new_cache = rec_cache._replace(
            rec_attr=take_rows(rec_cache.rec_attr),
            rec_edge_emb=take_rows(rec_cache.rec_edge_emb),
            rec_edge_mask=take(rec_cache.rec_edge_mask) & nbr_mask,
        )
    return new_batch, new_cache


def _phase_plan(cfg: SamplerConfig, n: int):
    """Validated (step, cap) compaction boundaries."""
    steps, caps = tuple(cfg.rec_phase_steps or ()), tuple(cfg.rec_phase_caps or ())
    if not steps:
        return ()
    if len(steps) != len(caps):
        raise ValueError("rec_phase_steps and rec_phase_caps must have equal length")
    if list(steps) != sorted(set(steps)) or steps[0] < 0 or steps[-1] >= n:
        raise ValueError(f"rec_phase_steps must be strictly increasing in [0, {n})")
    if list(caps) != sorted(set(caps), reverse=True):
        raise ValueError("rec_phase_caps must be strictly decreasing")
    return tuple(zip(steps, caps))


def _receptors_identical(batch: ComplexBatch) -> bool:
    """Every batch element carries the same receptor: every field an
    ``embed_receptor`` reads (residues and, where present, atoms)."""
    fields = (batch.rec_f, batch.rec_lm, batch.rec_pos, batch.rec_mask, batch.rec_nbr, batch.rec_nbr_mask,
              batch.atom_f, batch.atom_pos, batch.atom_mask, batch.atom_nbr, batch.atom_nbr_mask, batch.atom_res)
    return all(torch.equal(f, f[:1].expand_as(f)) for f in fields if f is not None)


def receptor_cache(model, batch: ComplexBatch, shared: bool = True):
    """The receptor embedding; with ``shared`` and a batch of replicas of
    one complex, embedded once at B=1 and copied to every pose. A batch of
    distinct receptors is embedded per element."""
    B = batch.batch_size
    if B == 1 or not shared or not _receptors_identical(batch):
        return model.embed_receptor(batch)
    cache1 = model.embed_receptor(batch.map(lambda a: a[:1]))
    return type(cache1)(*(a.expand((B,) + a.shape[1:]).contiguous() for a in cache1))


@torch.no_grad()
def sample(model, batch: ComplexBatch, model_cfg: ScoreModelConfig, cfg: SamplerConfig,
           generator: Optional[torch.Generator] = None, return_trajectory: bool = False, device=None):
    """Run the reverse diffusion. Returns (final batch, [steps, B, L, 3]
    trajectory or None). Runs on ``device`` (default: the GPU), where the
    model and the batch must already be."""
    dev = resolve_device(device)
    if batch.lig_pos.device.type != dev.type or next(model.parameters()).device.type != dev.type:
        raise ValueError(f"sample on {dev}: move the model and the batch there first")
    sched = make_schedules(cfg)
    n = num_steps(cfg)
    rec_cache = receptor_cache(model, batch, cfg.shared_receptor)
    traj = []
    pos = batch.lig_pos

    def run(seg_batch, seg_cache, pos, lo, hi):
        for i in range(lo, hi):
            pos = reverse_diffusion_step(model, seg_batch.replace(lig_pos=pos), seg_cache, i, sched, model_cfg, cfg,
                                         generator).lig_pos
            if return_trajectory:
                traj.append(pos)
        return pos

    plan = _phase_plan(cfg, n)
    seg_batch, seg_cache = batch, rec_cache
    bounds = [s for s, _ in plan] + [n]
    pos = run(seg_batch, seg_cache, pos, 0, bounds[0])
    for i, (s, cap) in enumerate(plan):
        t = torch.tensor(float(sched.t_tr[s]), dtype=torch.float32)
        tr_sigma = float(t_to_sigma(t, t, t, model_cfg.sigma)[0])
        base = 3.0 * tr_sigma + 20.0 if model_cfg.dynamic_max_cross else model_cfg.cross_max_distance
        radius = base + 3.0 * tr_sigma + cfg.rec_phase_margin
        seg_batch, seg_cache = _compact_receptor(seg_batch.replace(lig_pos=pos), seg_cache, radius, cap)
        pos = run(seg_batch, seg_cache, pos, s, bounds[i + 1])
    return batch.replace(lig_pos=pos), (torch.stack(traj) if return_trajectory else None)


@torch.no_grad()
def score_confidence(conf_model, batch: ComplexBatch, lig_pos=None, shared_receptor: bool = True,
                     compact: bool = True) -> torch.Tensor:
    """Confidence of each pose at t=0: [B]; NaN scores come back as -1000.

    ``batch`` is the confidence model's view of the complexes (with receptor
    atoms); ``lig_pos`` replaces its ligand positions with the poses to
    score. With ``compact`` and a model that crops (``crop_beyond``), each
    pose's kept residues and atoms are packed into the config's
    (crop_res_cap, crop_atom_cap) buckets before the forward, so the
    receptor embedding too runs on the cropped subgraph (as in training and
    the reference). Otherwise, with ``shared_receptor``, the receptor is
    embedded once and shared when every pose carries the same receptor."""
    if lig_pos is not None:
        batch = batch.replace(lig_pos=lig_pos)
    b = batch.set_time(0.0, 0.0, 0.0)
    cfg = conf_model.cfg
    rec_cache = None
    if (compact and cfg.all_atoms and cfg.crop_beyond is not None and cfg.crop_res_cap > 0
            and cfg.crop_atom_cap > 0 and b.atom_f is not None and b.rec_pos.shape[1] > cfg.crop_res_cap):
        b, _ = compact_crop(b, float(cfg.crop_beyond), cfg.crop_res_cap, cfg.crop_atom_cap)
    elif shared_receptor:
        rec_cache = receptor_cache(conf_model, b, shared=True)
    return torch.nan_to_num(conf_model(b, rec_cache=rec_cache).confidence, nan=-1000.0)
