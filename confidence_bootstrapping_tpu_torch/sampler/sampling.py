"""Reverse diffusion on T(3) x SO(3) x T^m.

Port of ``confidence_bootstrapping_tpu/sampler/sampling.py`` for the serving
path: ``randomize_position`` (with a pocket center), ``make_schedules``
(with per-manifold schedules), ``reverse_diffusion_step`` (with SVGD),
the shared receptor embedding, phased receptor compaction
(``_phase_plan``/``_compact_receptor``) and ``sample``. The ``lax.scan`` is a
Python loop and the ``lax.cond`` a Python branch. Randomness comes from an
explicit ``torch.Generator``; a step can instead take the noise tensors
(``tr_z``, ``rot_z``, ``tor_z``), so a test can feed the exact noise that
JAX's threefry drew. ``score_confidence`` scores poses with the all-atom
confidence model (crop and compaction per pose, or a shared receptor
embedding). The evaluator's per-complex host steps are here too:
``derive_phase_plan`` (host numpy, the same tuples as the JAX package's),
``with_derived_plan`` (the CLIs' ``rec_phase_auto`` default) and the cross
cap telemetry ``cross_overflow_stats``. ``sample`` takes the residue-level
and the all-atom score models (the all-atom one runs no phase plan: its
trunk reads the receptor atoms, which the plan does not compact).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SamplerConfig, ScoreModelConfig
from ..data.complex_graph import ComplexBatch
from ..models.all_atom_model import crop_to_caps, crops
from ..ops.geometry import matrix_to_axis_angle, quaternion_to_matrix, rigid_transform_kabsch
from ..ops.graph_builders import pairwise_dist, radius_mask
from ..ops.poses import modify_conformer
from ..ops.schedules import get_t_schedule, t_to_sigma
from ..ops.torsion import apply_torsion_updates, get_torsion_angles
from ..parallel import mesh as meshlib
from ..runtime import resolve_device


def uniform_rotation(generator: torch.Generator, n: int, device, q=None) -> torch.Tensor:
    """n uniform random rotation matrices via normalized quaternions (the
    quaternions ``q`` [n, 4] drawn from ``generator`` unless given)."""
    if q is None:
        q = torch.randn(n, 4, generator=generator, device=device)
    return quaternion_to_matrix(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def randomize_position(batch: ComplexBatch, generator: Optional[torch.Generator], tr_sigma_max: float,
                       no_torsion: bool = False, no_random: bool = False, pocket_center=None,
                       initial_noise_std_proportion: float = 1.0, *, tor_u=None, rot_q=None,
                       tr_z=None) -> ComplexBatch:
    """Random torsions, orientation and position around the receptor center
    (the t=1 prior), or around ``pocket_center`` [B, 3] where given (the
    CLIs' pocket-aware start). Draws torsions, then rotations, then the
    translation from ``generator``, unless they are given: ``tor_u`` [B, R]
    radians, ``rot_q`` [B, 4] unnormalized quaternions, ``tr_z`` [B, 3]
    standard normal."""
    B = batch.batch_size
    dev = batch.lig_pos.device
    pos = batch.lig_pos
    if not no_torsion:
        if tor_u is None:
            tor_u = torch.rand(batch.tor_src.shape, generator=generator, device=dev) * (2 * math.pi) - math.pi
        pos = apply_torsion_updates(pos, batch.tor_src, batch.tor_dst, batch.mask_rotate, tor_u, batch.tor_mask)
    m = batch.lig_mask.to(pos.dtype)[..., None]
    center = torch.sum(pos * m, dim=1, keepdim=True) / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    rot = uniform_rotation(generator, B, dev, rot_q)
    if pocket_center is None:
        rm = batch.rec_mask.to(pos.dtype)[..., None]
        pocket_center = torch.sum(batch.rec_pos * rm, dim=1) / torch.clamp(torch.sum(rm, dim=1), min=1.0)
    pocket_center = torch.as_tensor(pocket_center, dtype=pos.dtype, device=dev)
    pos = torch.einsum("bld,bed->ble", pos - center, rot) + pocket_center[:, None, :]
    if not no_random:
        if tr_z is None:
            tr_z = torch.randn(B, 3, generator=generator, device=dev)
        pos = pos + (tr_z * tr_sigma_max * initial_noise_std_proportion)[:, None, :]
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
    """The time grids of the executed steps and their decrements; with
    ``different_schedules`` rot and tor follow grids of their own (without
    ``t_max``, as in the JAX package)."""
    t_tr = get_t_schedule(cfg.inference_steps, cfg.sigma_schedule, cfg.inf_sched_alpha, cfg.inf_sched_beta,
                          t_max=cfg.t_max)
    if cfg.different_schedules:
        t_rot = get_t_schedule(cfg.inference_steps, cfg.rot_sigma_schedule, cfg.rot_inf_sched_alpha,
                               cfg.rot_inf_sched_beta)
        t_tor = get_t_schedule(cfg.inference_steps, cfg.tor_sigma_schedule, cfg.tor_inf_sched_alpha,
                               cfg.tor_inf_sched_beta)
    else:
        t_rot = t_tor = t_tr
    n = num_steps(cfg)

    def cut(t):
        t = np.asarray(t[:n], np.float32)
        return t, (t - np.concatenate([t[1:], np.zeros(1, np.float32)])).astype(np.float32)

    (t_tr, dt_tr), (t_rot, dt_rot), (t_tor, dt_tor) = cut(t_tr), cut(t_rot), cut(t_tor)
    return Schedules(t_tr, t_rot, t_tor, dt_tr, dt_rot, dt_tor)


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

    if tr_z is None:  # drawn at the global batch's rows under parallel.mesh.data_parallel
        tr_z = meshlib.rows(torch.randn, (B, 3), generator, dev)
        rot_z = meshlib.rows(torch.randn, (B, 3), generator, dev)
        tor_z = meshlib.rows(torch.randn, tor_score.shape, generator, dev)
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

    if cfg.svgd_weight_log_0 is not None and cfg.svgd_weight_log_1 is not None and not cfg.ode:
        # the particles couple across the whole pose batch: gathered under data parallel, then sliced again
        g = meshlib.gathered
        perturbs = _svgd_perturbations(
            batch.map(g), cfg, step_idx / num_steps(cfg), (g(tr_score), g(rot_score), g(tor_score)),
            (g(tr_z), g(rot_z), g(tor_z)), (tr_g, rot_g, tor_g), (dt_tr, dt_rot, dt_tor), sched, step_idx, model_cfg)
        tr_perturb, rot_perturb, tor_perturb = (meshlib.shard_rows(x) for x in perturbs)

    new_pos = modify_conformer(batch.lig_pos, batch.lig_mask, tr_perturb, rot_perturb,
                               None if model_cfg.no_torsion else tor_perturb,
                               batch.tor_src, batch.tor_dst, batch.mask_rotate, batch.tor_mask)
    return batch.replace(lig_pos=new_pos)


def _svgd_perturbations(batch: ComplexBatch, cfg: SamplerConfig, t_frac: float, scores, zs, gs, dts,
                        sched: Schedules, step_idx: int, model_cfg: ScoreModelConfig):
    """SVGD particle coupling across the pose batch (the JAX package's
    ``sampler/sampling.py:212-300``): the pairwise centroid, Kabsch
    rotation-vector and torsion-angle differences of the B poses drive a
    kernelized repulsion added to a tempered Langevin update. Each weight is
    10 ** (log_0 t_frac + log_1 (1 - t_frac)), 1 where a pair is unset. ->
    (tr, rot, tor) perturbations."""
    (tr_score, rot_score, tor_score), (tr_z, rot_z, tor_z) = scores, zs
    (tr_g, rot_g, tor_g), (dt_tr, dt_rot, dt_tor) = gs, dts
    B, R = batch.batch_size, batch.tor_src.shape[1]

    def interp(a, b):
        return 1.0 if a is None or b is None else 10 ** (a * t_frac + b * (1 - t_frac))

    svgd_weight = interp(cfg.svgd_weight_log_0, cfg.svgd_weight_log_1)
    repulsive_w = interp(cfg.svgd_repulsive_weight_log_0, cfg.svgd_repulsive_weight_log_1)
    kernel_size = interp(cfg.svgd_kernel_size_log_0, cfg.svgd_kernel_size_log_1)
    langevin_w = interp(cfg.svgd_langevin_weight_log_0, cfg.svgd_langevin_weight_log_1)
    rot_rel, tor_rel = 10 ** cfg.svgd_rot_log_rel_weight, 10 ** cfg.svgd_tor_log_rel_weight

    pos = batch.lig_pos
    if cfg.svgd_use_x0:  # compare the poses' one-step estimates of the clean pose
        def t(a):
            return float(a[step_idx])

        pos = modify_conformer(pos, batch.lig_mask, tr_g**2 * t(sched.t_tr) * tr_score,
                               rot_g**2 * t(sched.t_rot) * rot_score,
                               None if model_cfg.no_torsion else tor_g**2 * t(sched.t_tor) * tor_score,
                               batch.tor_src, batch.tor_dst, batch.mask_rotate, batch.tor_mask)

    mask = batch.lig_mask[0]
    m = mask.to(pos.dtype)[:, None]
    centroid = torch.sum(pos * m, dim=1) / torch.clamp(m.sum(), min=1.0)  # [B, 3]
    tr_diff = centroid[None, :, :] - centroid[:, None, :]  # [i, j] = c_j - c_i
    pi, pj = pos[:, None].expand(B, B, *pos.shape[1:]), pos[None, :].expand(B, B, *pos.shape[1:])
    rot_diff = matrix_to_axis_angle(rigid_transform_kabsch(pi, pj, mask.expand(B, B, -1))[0])  # [B, B, 3]
    tr_mat = torch.sum(tr_diff**2, -1, keepdim=True)
    rot_mat = torch.sum(rot_diff**2, -1, keepdim=True)

    has_tor = bool(R) and not model_cfg.no_torsion and batch.tor_dihedral is not None
    if has_tor:
        tau = torch.where(batch.tor_mask, get_torsion_angles(batch.tor_dihedral[0], pos), 0.0)
        tau_diff = torch.remainder(tau[:, None, :] - tau[None, :, :] + 3 * math.pi, 2 * math.pi) - math.pi
        tor_mat = torch.sum(tau_diff**2, -1, keepdim=True)
    else:
        tor_mat = 0.0

    total = tr_mat + rot_rel * rot_mat + tor_rel * tor_mat  # [B, B, 1]
    med2 = torch.quantile(total, 0.5, dim=1, keepdim=True)  # the median, averaging the middle two as numpy's
    h = kernel_size * med2 / max(math.log(float(B)), 1.0) + 1e-9
    k = torch.exp(-total / h)
    tr_rep = torch.sum(2 / h * tr_diff * k, dim=1)
    rot_rep = torch.sum(2 / h * rot_rel * rot_diff * k, dim=1)

    tr_perturb = (0.5 * tr_g**2 * dt_tr * tr_score
                  + langevin_w * (0.5 * tr_g**2 * dt_tr * tr_score + tr_g * torch.sqrt(dt_tr) * tr_z)
                  + svgd_weight * (tr_g**2 * dt_tr * (tr_score + repulsive_w * tr_rep / B)))
    rot_perturb = (0.5 * rot_g**2 * dt_rot * rot_score
                   + langevin_w * (0.5 * rot_g**2 * dt_rot * rot_score + rot_g * torch.sqrt(dt_rot) * rot_z)
                   + svgd_weight * (rot_g**2 * dt_rot * (rot_score + repulsive_w * rot_rep / B)))
    tor_perturb = (0.5 * tor_g**2 * dt_tor * tor_score
                   + langevin_w * (0.5 * tor_g**2 * dt_tor * tor_score + tor_g * torch.sqrt(dt_tor) * tor_z))
    if has_tor:
        tor_rep = torch.sum(2 / h * tor_rel * tau_diff * k, dim=1)
        tor_perturb = tor_perturb + svgd_weight * (tor_g**2 * dt_tor * (tor_score + repulsive_w * tor_rep / B))
    return tr_perturb, rot_perturb, tor_perturb


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
    pri = meshlib.all_min(torch.where(batch.rec_mask & (d < radius), d, inf).amin(dim=0))  # [N] over all poses
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


def derive_phase_plan(model_cfg: ScoreModelConfig, cfg: SamplerConfig, rec_pos, rec_mask
                      ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Host-side phased-compaction plan of one receptor: (steps, caps), as
    the JAX package derives it (``sampler/sampling.py:446-544``).

    For each candidate cap (the bucket halved until 128) the earliest step,
    on a grid of 4, where the median count of residues within the keep
    radius 3 sigma_tr(s) + 20 + rec_phase_margin of a residue is at most the
    cap; then the one or two boundaries that minimize the receptor
    node-steps plus a per-segment penalty. ((), ()) without a dynamic cross
    cutoff, for all-atom models, under 8 steps or at N <= 128.
    ``rec_pos`` [N, 3] / ``rec_mask`` [N]: numpy arrays or tensors of the
    padded receptor."""
    n = num_steps(cfg)
    N = int(rec_pos.shape[-2])
    if not model_cfg.dynamic_max_cross or model_cfg.all_atoms or n < 8 or N <= 128:
        return (), ()
    pos = np.asarray(rec_pos, dtype=np.float32).reshape(-1, 3)[:N]
    pos = pos[np.asarray(rec_mask, dtype=bool).reshape(-1)[:N]]
    if pos.shape[0] == 0:
        return (), ()
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    sp = model_cfg.sigma
    sigmas = np.asarray([float(t_to_sigma(t, t, t, sp)[0]) for t in make_schedules(cfg).t_tr])

    def med_count(s: int) -> int:
        R = 3.0 * sigmas[s] + 20.0 + cfg.rec_phase_margin
        return int(np.median(np.sum(d2 < R * R, axis=1)))

    caps, c = [], N // 2
    while c >= 128:
        caps.append(c)
        c //= 2
    cands, prev_step = [], 0  # the earliest viable step of each cap, in cap order
    for cap in caps:
        s_found = next((s for s in range(prev_step, n - 3, 4) if med_count(s) <= cap), None)
        if s_found is None:
            break
        cands.append((s_found, cap))
        prev_step = s_found + 4

    def node_steps(plan):
        total, n_cur, prev = 0, N, 0
        for s, cap in plan:
            total += (s - prev) * n_cur
            n_cur, prev = cap, s
        return total + (n - prev) * n_cur

    best, best_cost = (), node_steps(())
    for r in (1, 2):
        for combo in itertools.combinations(cands, r):
            cost = node_steps(combo) + r * 0.005 * n * N  # per-segment penalty
            if len({s for s, _ in combo}) == r and cost < best_cost:
                best, best_cost = combo, cost
    return tuple(s for s, _ in best), tuple(c for _, c in best)


def with_derived_plan(model_cfg: ScoreModelConfig, cfg: SamplerConfig, rec_pos, rec_mask) -> SamplerConfig:
    """``cfg`` with the plan ``derive_phase_plan`` gives this receptor, when
    ``rec_phase_auto`` is on and no plan is set (the JAX CLIs' per-complex
    default, ``cli/infer.py:390-412``); otherwise ``cfg`` as it is."""
    if not cfg.rec_phase_auto or cfg.rec_phase_steps:
        return cfg
    steps, caps = derive_phase_plan(model_cfg, cfg, rec_pos, rec_mask)
    return dataclasses.replace(cfg, rec_phase_steps=steps, rec_phase_caps=caps) if steps else cfg


@torch.no_grad()
def cross_overflow_stats(batch: ComplexBatch, model_cfg: ScoreModelConfig) -> dict:
    """Cross-edge cap telemetry of a batch (the JAX package's
    ``sampler/sampling.py:301-349``): per real ligand atom, the receptor
    residues within the cross cutoff against the cap
    ``effective_cross_cap(N)``, at the widest cutoff (sigma_tr max) and at
    the final step's (sigma_tr min). -> {overflow_atom_frac,
    dropped_edge_frac, overflow_atom_frac_final, dropped_edge_frac_final}:
    the share of atoms that lose edges to the cap and of in-radius edges
    dropped (always the farthest: the model keeps the nearest), as floats."""
    sp = model_cfg.sigma
    cap = model_cfg.effective_cross_cap(batch.rec_pos.shape[1])
    real = batch.lig_mask
    n_atoms = torch.clamp(real.sum(), min=1)

    def stats_at(cutoff: float):
        m, _ = radius_mask(batch.lig_pos, batch.rec_pos, cutoff, batch.lig_mask, batch.rec_mask)
        counts = m.sum(-1)  # [B, L] in-radius residues
        overflow = ((counts > cap) & real).sum() / n_atoms
        dropped = (torch.clamp(counts - cap, min=0) * real).sum()
        return float(overflow), float(dropped / torch.clamp((counts * real).sum(), min=1))

    if model_cfg.dynamic_max_cross:
        worst, final = sp.tr_sigma_max * 3 + 20, sp.tr_sigma_min * 3 + 20
    else:
        worst = final = model_cfg.cross_max_distance
    oa_w, de_w = stats_at(worst)
    oa_f, de_f = stats_at(final)
    return dict(overflow_atom_frac=oa_w, dropped_edge_frac=de_w, overflow_atom_frac_final=oa_f,
                dropped_edge_frac_final=de_f)


def _receptors_identical(batch: ComplexBatch) -> bool:
    """Every batch element carries the same receptor: every field an
    ``embed_receptor`` reads (residues and, where present, atoms)."""
    fields = (batch.rec_f, batch.rec_lm, batch.rec_pos, batch.rec_mask, batch.rec_nbr, batch.rec_nbr_mask,
              batch.atom_f, batch.atom_pos, batch.atom_mask, batch.atom_nbr, batch.atom_nbr_mask, batch.atom_res)
    return all(torch.equal(f, f[:1].expand_as(f)) for f in fields if f is not None)


def receptor_cache(model, batch: ComplexBatch, shared: bool = True):
    """The receptor embedding; with ``shared`` and a batch of replicas of
    one complex, embedded once at B=1 and copied to every pose. A batch of
    distinct receptors is embedded per element. None for a model with no
    cacheable receptor phase (the legacy models, whose forward ignores
    ``rec_cache``)."""
    if not hasattr(model, "embed_receptor"):
        return None
    B = batch.batch_size
    if B == 1 or not shared or not _receptors_identical(batch):
        return model.embed_receptor(batch)
    cache1 = model.embed_receptor(batch.map(lambda a: a[:1]))
    return type(cache1)(*(a.expand((B,) + a.shape[1:]).contiguous() for a in cache1))


@torch.no_grad()
def sample(model, batch: ComplexBatch, model_cfg: ScoreModelConfig, cfg: SamplerConfig,
           generator: Optional[torch.Generator] = None, return_trajectory: bool = False, device=None,
           mesh: Optional[meshlib.Mesh] = None):
    """Run the reverse diffusion. Returns (final batch, [steps, B, L, 3]
    trajectory or None). Runs on ``device`` (default: the GPU), where the
    model and the batch must already be.

    ``mesh`` (``parallel.mesh``): every rank passes the same global batch
    and generator state and runs its slice of the poses, with the receptor
    cache its own; the noise is drawn at the global batch's rows, the phase
    compaction keeps the residues of all poses, SVGD couples all poses, and
    the final poses (and trajectory) are gathered, so every rank returns the
    one-process result. A batch that does not split over the data axis runs
    whole on every rank."""
    dev = resolve_device(device)
    if batch.lig_pos.device.type != dev.type or next(model.parameters()).device.type != dev.type:
        raise ValueError(f"sample on {dev}: move the model and the batch there first")
    dp = meshlib.data_mesh(mesh, batch.batch_size)
    if dp is None:
        return _sample(model, batch, model_cfg, cfg, generator, return_trajectory)
    with meshlib.data_parallel(dp):
        final, traj = _sample(model, meshlib.shard_batch(dp, batch), model_cfg, cfg, generator, return_trajectory)
        pos = meshlib.gathered(final.lig_pos)
        traj = None if traj is None else meshlib.gathered(traj.transpose(0, 1)).transpose(0, 1)
    return batch.replace(lig_pos=pos), traj


def _sample(model, batch: ComplexBatch, model_cfg: ScoreModelConfig, cfg: SamplerConfig,
            generator: Optional[torch.Generator], return_trajectory: bool):
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

    plan = _phase_plan(cfg, n) if not model_cfg.all_atoms else ()
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
                     compact: bool = True, embed_full_receptor: bool = False) -> torch.Tensor:
    """Confidence of each pose at t=0: [B]; NaN scores come back as -1000.

    ``batch`` is the confidence model's view of the complexes (with receptor
    atoms); ``lig_pos`` replaces its ligand positions with the poses to
    score. With ``compact`` and a model that crops (``crop_beyond``), each
    pose's kept residues and atoms are packed into the config's
    (crop_res_cap, crop_atom_cap) buckets before the forward, so the
    receptor embedding too runs on the cropped subgraph (as in training and
    the reference). Otherwise, with ``shared_receptor``, the receptor is
    embedded once and shared when every pose carries the same receptor.
    ``embed_full_receptor`` (with ``compact`` and ``shared_receptor``): the
    JAX package's opt-in path, which embeds the full receptor once and
    compacts the batch and that embedding for the trunk (the embeddings then
    see the uncropped graph, unlike training)."""
    if lig_pos is not None:
        batch = batch.replace(lig_pos=lig_pos)
    b = batch.set_time(0.0, 0.0, 0.0)
    rec_cache = None
    if compact and crops(conf_model.cfg, b):
        if embed_full_receptor and shared_receptor:
            rec_cache = receptor_cache(conf_model, b, shared=True)
        b, rec_cache, _ = crop_to_caps(conf_model.cfg, b, rec_cache)
    elif shared_receptor:
        rec_cache = receptor_cache(conf_model, b, shared=True)
    return torch.nan_to_num(conf_model(b, rec_cache=rec_cache).confidence, nan=-1000.0)
