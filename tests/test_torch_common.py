"""Shared inputs of the PyTorch-port parity tests: the 1a0q complex padded for
both packages, a tiny score-model config, and the JAX package's score-norm
tables installed in the port (so the CPU tests do not build the full tables;
tests/test_torch_ops.py checks the port's own builder row by row)."""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import threadpoolctl
import torch

from confidence_bootstrapping_tpu.config import ScoreModelConfig as JaxScoreConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig
from confidence_bootstrapping_tpu_torch.data import complex_graph as tcg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKL = os.path.join(ROOT, "cache", "1a0q_44f574e0e5cb3bc5.pkl")

TINY = dict(ns=16, nv=4, num_conv_layers=2, num_prot_emb_layers=1)


def share_the_cores() -> None:
    """Under pytest-xdist, size each worker's BLAS and torch thread pools to
    its share of the cores. Pools sized to every core each, in several
    workers at once, oversubscribe the machine many times over, and the
    spinning BLAS threads make a numpy SVD (the Clebsch-Gordan solves) tens
    of times slower than in one process. Every worker imports this module
    while it collects the suite, so the sizes hold for every test it runs;
    one process alone keeps the defaults."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        threadpoolctl.threadpool_limits(1, user_api="blas")
        torch.set_num_threads(max(1, -(-(os.cpu_count() or 1) // workers)))


share_the_cores()


def tiny_configs(lm_dim: int):
    """(JAX config, port config) of the tiny score model, dropout off."""
    return (JaxScoreConfig(lm_embedding_dim=lm_dim, dropout=0.0, **TINY),
            ScoreModelConfig(lm_embedding_dim=lm_dim, dropout=0.0, **TINY))


def padded_1a0q(lm_dim: int, seed: int = 0):
    """The padded 1a0q complex (numpy dict), with random ESM-like receptor
    features of width lm_dim as bench.py makes them."""
    with open(PKL, "rb") as f:
        hc = pickle.load(f)[0]
    if lm_dim:
        hc = hc._replace(rec_lm=np.random.RandomState(seed).randn(len(hc.rec_f), lm_dim).astype(np.float32))
    bucket = jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))
    return jcg.pad_complex(hc, bucket, lm_dim=lm_dim)


def both_batches(padded: dict, B: int, lig_pos=None, t: float = 0.5):
    """The same B-pose batch for JAX and for the port (on the CPU)."""
    jb = jcg.replicate_complex(padded, B)
    if lig_pos is not None:
        jb = jb.replace(lig_pos=jnp.asarray(lig_pos, jnp.float32))
    jb = jb.set_time(t, t, t)
    return jb, port_batch(jb)


def port_batch(jb):
    """The port's ComplexBatch (CPU) of a JAX ComplexBatch; absent fields stay None."""
    fields = {k: getattr(jb, k) for k in tcg.ComplexBatch.__dataclass_fields__}
    return tcg.ComplexBatch(**{
        k: None if v is None else torch.as_tensor(np.asarray(v).astype(np.int64) if np.asarray(v).dtype == np.int32
                                                  else np.array(v)) for k, v in fields.items()
    })


def perturbed_pose(padded: dict, B: int, seed: int = 0, scale: float = 1.5):
    """B poses: the crystal ligand jittered per pose (numpy, [B, L, 3])."""
    rng = np.random.RandomState(seed)
    return padded["lig_pos"][None] + rng.randn(B, *padded["lig_pos"].shape).astype(np.float32) * scale


def randomize_stats(variables, seed: int = 0):
    """Flax variables with random batch-norm statistics and affine params, so
    a parity test exercises the batch norm (numpy tree)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(d, path=()):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif _is_norm(path) and k in ("mean", "bias"):
                out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
            elif _is_norm(path) and k in ("var", "norm", "weight", "scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(tree)


def _is_norm(path) -> bool:
    """A batch norm's variables: the TP-convs' ``bn`` or a confidence head's
    ``MaskedBatchNorm1d_<i>``."""
    return "bn" in path or any(p.startswith("MaskedBatchNorm1d") for p in path)


def install_jax_score_norms(monkeypatch):
    """Serve the port's so3/torus score-norm lookups from the JAX tables."""
    from confidence_bootstrapping_tpu.ops import so3 as jso3, torus as jtorus
    from confidence_bootstrapping_tpu_torch.ops import so3, torus

    s = torch.as_tensor(np.array(jso3.EXP_SCORE_NORM))
    t = torch.as_tensor(np.array(jtorus.SCORE_NORM_TABLE))
    monkeypatch.setattr(so3, "_table", lambda device: s.to(device))
    monkeypatch.setattr(torus, "_table", lambda device: t.to(device))


def install_jax_tables(monkeypatch):
    """Serve every so3/torus lookup of the port (score norms, the IGSO(3)
    cdf and score grids, the torus score table) from the JAX tables, so the
    CPU tests build none of them."""
    from confidence_bootstrapping_tpu.ops import so3 as jso3, torus as jtorus
    from confidence_bootstrapping_tpu_torch.ops import so3, torus

    install_jax_score_norms(monkeypatch)
    cdf, score = torch.as_tensor(np.array(jso3.CDF)), torch.as_tensor(np.array(jso3.SCORE))
    table = torch.as_tensor(np.array(jtorus.SCORE_TABLE))
    monkeypatch.setattr(so3, "_grids", lambda device: (cdf.to(device), score.to(device)))
    monkeypatch.setattr(torus, "_score_table", lambda device: table.to(device))


def assert_port_fields(d: dict, jd: dict, jdefaults: dict, every: bool) -> None:
    """The port's config dict ``d`` equals the JAX one ``jd`` on the port's
    fields, in the JAX order; the JAX fields the port lacks (none when
    ``every``) are at their defaults, so the port drops no setting."""
    assert list(d) == [k for k in jd if k in d] and d == {k: jd[k] for k in d}
    rest = [k for k in jd if k not in d]
    assert not (every and rest) and {k: jd[k] for k in rest} == {k: jdefaults[k] for k in rest}
