"""The port's all-atom confidence model and rerank against the JAX package.

A small all-atom complex: the 1a0q ligand and the 48 receptor residues within
10 A of its crystal pose (buckets N=64, A=512), with seeded receptor atoms
(chip_smoke.receptor_atoms: 7-8 heavy atoms per residue near its C-alpha,
kNN K=8 within 5 A) and random 16-wide receptor language-model features.
The confidence architecture at ns=8, nv=2 and 2 trunk layers, with a crop of
7 A and caps of 16 residues and 120 atoms, so that compaction happens and
both caps overflow. Weights are the JAX model's, carried over by
``models/from_flax.py``, with random batch-norm statistics. On the CPU the
JAX model takes its XLA path and the port its kernels' plain versions, both
in float32. Tolerance: |port - jax| <= 2e-4 * max(1, max |jax|).
"""

import dataclasses
import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import chip_smoke
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models import all_atom_model as jaam
from confidence_bootstrapping_tpu.models.factory import confidence_model_config as jax_confidence_config
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu_torch.config import confidence_model_config
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg
from confidence_bootstrapping_tpu_torch.models import all_atom_model as taam
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.sampler import sampling
from test_torch_common import PKL, perturbed_pose, port_batch, randomize_stats

B = 2
REL = 2e-4
LM = 16
SMALL = dict(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=LM, crop_beyond=7.0, crop_res_cap=16, crop_atom_cap=120)
CONFIGS = {
    "default": SMALL,  # no embedding layers, as the pretrained confidence model
    "embedding": dict(SMALL, num_prot_emb_layers=1, embed_also_ligand=True),  # the 4-group receptor embedding
    "atom_head": dict(SMALL, num_conv_layers=3, atom_confidence=True),  # 3 layers: the pooled [:ns | -ns:] input
}


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0, atol=rel * scale)


@functools.lru_cache(maxsize=None)
def small_complex():
    """The padded small all-atom 1a0q complex (numpy dict, JAX layout)."""
    with open(PKL, "rb") as f:
        hc = pickle.load(f)[0]
    d = np.linalg.norm(hc.rec_pos[:, None] - hc.orig_lig_pos[None], axis=-1).min(1)
    keep = np.flatnonzero(d < 10.0)
    rec_pos = hc.rec_pos[keep]
    dist, nbr = cKDTree(rec_pos).query(rec_pos, k=25)
    atoms = chip_smoke.receptor_atoms(hc.rec_f[keep], rec_pos, n_atoms=int(len(keep) * 3183 / 416), seed=3)
    rng = np.random.RandomState(0)
    hc = hc._replace(rec_f=hc.rec_f[keep], rec_pos=rec_pos, rec_lm=rng.randn(len(keep), LM).astype(np.float32),
                     rec_nbr=nbr[:, 1:].astype(np.int32), rec_nbr_mask=dist[:, 1:] < 15.0,
                     **{k: v.astype(np.int32) if v.dtype == np.int64 else v for k, v in atoms.items()})
    bucket = jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                             n_atoms=len(hc.atom_f), all_atoms=True)
    assert (bucket.N, bucket.A) == (64, 512)
    return jcg.pad_complex(hc, bucket, lm_dim=LM), hc


def _batches(scale=1.0, seed=0):
    padded, _ = small_complex()
    jb = jcg.replicate_complex(padded, B)
    jb = jb.replace(lig_pos=jax.numpy.asarray(perturbed_pose(padded, B, seed=seed, scale=scale))).set_time(0.0, 0.0, 0.0)
    return jb, port_batch(jb)


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg = CONFIGS[name]
    jcfg = jax_confidence_config(**dict(cfg, dropout=0.0))
    jmodel = jaam.AllAtomScoreModel(jcfg)
    jb, _ = _batches()
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb), seed=1)
    model = taam.AllAtomScoreModel(confidence_model_config(**cfg), device="cpu")
    from_flax.load_flax_variables(model, variables)
    return jmodel, variables, model


def _compare_batches(got: tcg.ComplexBatch, want):
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f.name)), err_msg=f.name)


@pytest.mark.parametrize("crop,n_res,n_atoms", [(7.0, 16, 120), (7.0, 64, 512), (1e6, 64, 512), (9.0, 40, 100)])
def test_compact_crop_matches_jax(crop, n_res, n_atoms):
    """The same residues and atoms survive, in the same slots, with the same
    remapped neighbour lists and masks; on cap overflow (atoms of a residue
    share its distance: tied keys) the same nearest ones survive."""
    jb, tb = _batches()
    jout, _, jstats = jaam.compact_crop(jb, None, crop, n_res, n_atoms)
    tout, _, tstats = taam.compact_crop(tb, None, crop, n_res, n_atoms)
    _compare_batches(tout, jout)
    for k, v in jstats.items():
        np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(v), err_msg=k)
    if n_res == 16:
        assert int(tstats["atom_overflow"].min()) > 0 and int(tstats["res_overflow"].min()) > 0


def test_select_pack_ties_keep_the_lower_index():
    keep = torch.tensor([[True, True, True, False, True, True]])
    key = torch.tensor([[2.0, 1.0, 1.0, 0.0, 1.0, 3.0]])
    sel, valid, inv, selected = taam._select_pack(keep, key, 3)
    assert sel.tolist() == [[1, 2, 4]] and valid.all()
    assert selected.tolist() == [[False, True, True, False, True, False]]
    assert inv[0, [1, 2, 4]].tolist() == [0, 1, 2]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_confidence_forward_matches_jax(name):
    """The model forward on the compacted view (where the receptor
    embedding, the crop mask and every trunk group run) and on the full
    buckets."""
    jmodel, variables, model = _models(name)
    jb, tb = _batches()
    c = model.cfg
    jc, _, _ = jaam.compact_crop(jb, None, c.crop_beyond, c.crop_res_cap, c.crop_atom_cap)
    tc, _, _ = taam.compact_crop(tb, None, c.crop_beyond, c.crop_res_cap, c.crop_atom_cap)
    apply = jax.jit(jmodel.apply)
    for jbatch, tbatch in ((jc, tc), (jb, tb)):
        want, got = apply(variables, jbatch), model(tbatch)
        assert got.confidence.shape == (B,)
        _close(got.confidence, want.confidence)
        if c.atom_confidence:
            _close(got.atom_confidence, want.atom_confidence)


def test_embed_receptor_matches_jax():
    jmodel, variables, model = _models("embedding")
    jb, tb = _batches()
    want = jax.jit(functools.partial(jmodel.apply, method="embed_receptor"))(variables, jb)
    got = model.embed_receptor(tb)
    for f in taam.AtomRecCache._fields:
        _close(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("compact", [True, False])
def test_score_confidence_matches_jax(compact):
    """Both branches of score_confidence: crop and compact per pose, and the
    full buckets with the receptor embedded once and shared."""
    jmodel, variables, model = _models("embedding")
    jb, tb = _batches(scale=2.0, seed=4)
    pos = perturbed_pose(small_complex()[0], B, seed=5, scale=1.0)
    want = jsampling.score_confidence(jmodel, variables, jb, lig_pos=jax.numpy.asarray(pos), compact=compact)
    got = sampling.score_confidence(model, tb, lig_pos=torch.as_tensor(pos), compact=compact)
    _close(got, want)


def test_score_confidence_maps_nan_to_minus_1000(monkeypatch):
    _, _, model = _models("default")
    _, tb = _batches()
    monkeypatch.setattr(model.confidence_predictor.layers[2].bias, "data",
                        torch.full_like(model.confidence_predictor.layers[2].bias, float("nan")))
    assert sampling.score_confidence(model, tb).tolist() == [-1000.0] * B


def test_bridge_maps_every_variable():
    """Every Flax leaf of the all-atom model (the 4- and 9-group TPConvs, the
    confidence head's Dense and MaskedBatchNorm1d) lands on a port tensor."""
    _, variables, model = _models("embedding")
    sd = from_flax.state_dict_from_flax(variables)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(jax.tree.leaves(variables))
    head = variables["batch_stats"]["confidence_predictor"]["MaskedBatchNorm1d_1"]["var"]
    np.testing.assert_array_equal(sd["confidence_predictor.norms.1.var"].numpy(), head)
    assert len(model.rec_emb_layers[0].edge_mlps) == 4 and len(model.conv_layers[0].edge_mlps) == 9
    assert len(model.conv_layers[-1].edge_mlps) == 3


def test_atoms_pad_and_bucket_like_jax():
    assert tcg.pick_bucket(23, 46, 11, 416, n_atoms=3183, all_atoms=True)[:4] == (24, 48, 16, 512)
    assert tcg.pick_bucket(23, 46, 11, 416, n_atoms=3183, all_atoms=True).A == 4096  # 1a0q's all-atom bucket
    padded, hc = small_complex()
    hct = tcg.HostComplex(**hc._asdict())
    bucket = tcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                             n_atoms=len(hc.atom_f), all_atoms=True)
    assert tuple(bucket) == tuple(jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                                                  n_atoms=len(hc.atom_f), all_atoms=True))
    got = tcg.pad_complex(hct, bucket, lm_dim=LM)
    for k, v in got.items():
        np.testing.assert_array_equal(v, padded[k], err_msg=k)


def test_atom_knn_matches_brute_force():
    pos = (np.random.RandomState(2).randn(300, 3) * 6).astype(np.float32)
    nbr, mask = tcg.atom_knn(pos, 5.0, 8)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    want = np.sort(d, axis=1)[:, :8]
    np.testing.assert_allclose(np.take_along_axis(d, nbr, 1), want, rtol=1e-5)
    np.testing.assert_array_equal(mask, want < 5.0)


def test_seeded_receptor_atoms():
    """chip_smoke's stand-in atoms: the requested count, at least 4 per
    residue, within 4 A of their C-alpha, features within the vocabulary."""
    from confidence_bootstrapping_tpu_torch.data.vocab import REC_ATOM_FEATURE_DIMS

    rng = np.random.RandomState(0)
    rec_pos = (rng.randn(40, 3) * 8).astype(np.float32)
    rec_f = rng.randint(0, 20, 40)
    a = chip_smoke.receptor_atoms(rec_f, rec_pos, 306, seed=1)
    assert a["atom_f"].shape == (306, 4) and np.bincount(a["atom_res"]).min() >= 4
    assert np.linalg.norm(a["atom_pos"] - rec_pos[a["atom_res"]], axis=-1).max() <= 4.0 + 1e-5
    assert (a["atom_f"] < np.asarray(REC_ATOM_FEATURE_DIMS)).all() and (a["atom_f"][:, 0] == rec_f[a["atom_res"]]).all()
    b = chip_smoke.receptor_atoms(rec_f, rec_pos, 306, seed=1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
