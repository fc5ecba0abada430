"""The composed TP-conv route of the port against the JAX package: rows 4, 5,
6 and 13 of the kernel table, the two routes against each other, the score
model with a pinned cross cap and a ligand off the 8-grid, and the
evaluator's host steps (phase plan, cross-cap telemetry).

Kernels: each plain PyTorch version (what the CUDA wrapper runs for CPU
tensors) gets the same numpy inputs as the Pallas function, run as
tests/test_pallas_tpconv.py runs it (interpret=True, use_bf16=False), at
rtol = atol = 2e-4. Routes: the fused plain versions against the composed
ones at 2e-4 x max(1, max |fused|) (float32 sums in another order). Model:
|port - jax| <= 2e-4 x max(1, max |jax|) per output; on the CPU the JAX model
takes its XLA path, which composes the same way at any cap.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.config import SamplerConfig as JaxSamplerConfig
from confidence_bootstrapping_tpu.data import complex_graph as jcg
from confidence_bootstrapping_tpu.models.score_model import TensorProductScoreModel as JaxModel
from confidence_bootstrapping_tpu.ops.pallas import tpconv as jv1
from confidence_bootstrapping_tpu.ops.pallas import tpconv_rec as jrec
from confidence_bootstrapping_tpu.ops.pallas import tpconv_v3 as jv3
from confidence_bootstrapping_tpu.sampler import sampling as jsampling
from confidence_bootstrapping_tpu_torch.config import SamplerConfig
from confidence_bootstrapping_tpu_torch.models import from_flax
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv, tpconv_lig, tpconv_rec, tpconv_v3
from confidence_bootstrapping_tpu_torch.ops.graph_builders import gather_nodes, scatter_mean_to_nodes
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct, spherical_harmonics
from confidence_bootstrapping_tpu_torch.sampler import sampling
from test_torch_common import PKL, install_jax_score_norms, padded_1a0q, port_batch, randomize_stats, tiny_configs

SMALL = "8x0e + 3x1o + 3x1e + 2x0o"
FLAGSHIP = "32x0e + 6x1o + 6x1e + 6x0o"
SH1 = "1x0e + 1x1o"
TOL = dict(rtol=2e-4, atol=2e-4)
REL = 2e-4


def _ns(irreps):
    return int(irreps.split("x")[0])


def _weights(rng, F, H, W):
    return [rng.randn(F, H).astype(np.float32) * 0.2, rng.randn(H).astype(np.float32) * 0.1,
            rng.randn(H, W).astype(np.float32) * 0.2, rng.randn(W).astype(np.float32) * 0.1]


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def _rel_close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _cross_case(irreps, B, L, N, K, seed):
    rng = np.random.RandomState(seed)
    ns = _ns(irreps)
    tp = WeightedTensorProduct(irreps, SH1, irreps)
    D = tp.irreps_in.dim
    lig = rng.randn(B, L, D).astype(np.float32)
    lpos = (rng.randn(B, L, 3) * 2).astype(np.float32)
    rec = rng.randn(B, N, D).astype(np.float32)
    rpos = (rng.randn(B, N, 3) * 4).astype(np.float32)
    idx = rng.randint(0, N, (B, L, K)).astype(np.int32)
    emb = rng.randn(B, L, K, ns).astype(np.float32)
    mask = rng.rand(B, L, K) > 0.3
    mask[0, 1] = False  # a receiver whose whole list is masked
    return (lig, lpos, rec, rpos, idx, emb, mask), rng, tp, ns


@pytest.mark.parametrize("irreps,K", [(SMALL, 100), (FLAGSHIP, 12), (SMALL, 7)])
def test_cross_plain_matches_pallas(irreps, K):
    """Row 4: ligand <- receptor sums at a K off the 16-grid."""
    args, rng, tp, ns = _cross_case(irreps, 2, 8, 24, K, 0)
    w = _weights(rng, 3 * ns, 3 * ns, tp.weight_numel)
    want = jrec.fused_tpconv_cross(*args, *w, irreps, irreps, ns, interpret=True, use_bf16=False)
    got = tpconv_rec.fused_tpconv_cross(*map(_torch, args + tuple(w)), irreps, irreps, ns,
                                        interpret=True, use_bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0, 1].abs().max()) == 0.0


def _edge_case(irreps, M, K, seed):
    rng = np.random.RandomState(seed)
    tp = WeightedTensorProduct(irreps, SH1, irreps)
    F = 3 * _ns(irreps)
    attr = rng.randn(M, K, F).astype(np.float32)
    sender = rng.randn(M, K, tp.irreps_in.dim).astype(np.float32)
    sh = spherical_harmonics(1, torch.as_tensor(rng.randn(M, K, 3).astype(np.float32))).numpy()
    mask = rng.rand(M, K) > 0.3
    mask[8:16] = False  # a wholly masked tile of the Pallas grid
    return (attr, sender, sh, mask, *_weights(rng, F, F, tp.weight_numel))


@pytest.mark.parametrize("api", ["v3", "v1"])
@pytest.mark.parametrize("irreps,M,K", [(SMALL, 24, 6), (FLAGSHIP, 16, 23)])
def test_edge_list_plain_matches_pallas(api, irreps, M, K):
    """Rows 5 and 6 (v3) and row 13 (v1): sums over K and per-edge messages,
    masked edges exactly zero."""
    case = _edge_case(irreps, M, K, 1)
    jmod, tmod = (jv3, tpconv_v3) if api == "v3" else (jv1, tpconv)
    want_sum = jmod.fused_tpconv_nbr(*case, irreps, irreps, tile_m=8, interpret=True, use_bf16=False)
    want_msg = jmod.fused_tpconv_msgs(*case, irreps, irreps, tile_m=8, interpret=True, use_bf16=False)
    targs = tuple(map(_torch, case))
    got_sum = tmod.fused_tpconv_nbr(*targs, irreps, irreps, tile_m=8, interpret=True, use_bf16=False)
    got_msg = tmod.fused_tpconv_msgs(*targs, irreps, irreps, tile_m=8, interpret=True, use_bf16=False)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum), **TOL)
    np.testing.assert_allclose(got_msg.numpy(), np.asarray(want_msg), **TOL)
    assert got_msg.shape == (M, K, WeightedTensorProduct(irreps, SH1, irreps).irreps_out.dim)
    assert float(got_msg[8:16].abs().max()) == 0.0 and float(got_msg[~targs[3]].abs().max()) == 0.0


def test_composed_cross_equals_cross_rev():
    """At K=100: row 4 plus row 6 over the reversed lists plus the scatter
    equal the plain cross_rev, both directions."""
    args, rng, tp, ns = _cross_case(FLAGSHIP, 2, 8, 40, 100, 2)
    lig, lpos, rec, rpos, idx, emb, mask = map(_torch, args)
    wf = [_torch(a) for a in _weights(rng, 3 * ns, 3 * ns, tp.weight_numel)]
    wr = [_torch(a) for a in _weights(rng, 3 * ns, 3 * ns, tp.weight_numel)]
    want_l, want_r = tpconv_lig.tpconv_cross_rev_plain(lig, lpos, rec, rpos, idx, emb, mask, *wf, *wr, FLAGSHIP,
                                                       FLAGSHIP, ns)
    got_l = tpconv_rec.fused_tpconv_cross(lig, lpos, rec, rpos, idx, emb, mask, *wf, FLAGSHIP, FLAGSHIP, ns)
    B, L, K = idx.shape
    sh_rev = spherical_harmonics(1, lpos[:, :, None, :] - gather_nodes(rpos, idx))
    lscal = lig[:, :, None, :ns].expand(B, L, K, ns)
    eattr = torch.cat([emb, gather_nodes(rec, idx)[..., :ns], lscal], dim=-1)
    sender = lig[:, :, None].expand(B, L, K, -1).reshape(B * L, K, -1)
    msg = tpconv_v3.fused_tpconv_msgs(eattr.reshape(B * L, K, -1), sender, sh_rev.reshape(B * L, K, -1),
                                      mask.reshape(B * L, K), *wr, FLAGSHIP, FLAGSHIP)
    got_r, _ = scatter_mean_to_nodes(msg.reshape(B, L * K, -1), idx.reshape(B, -1), mask.reshape(B, -1), rec.shape[1])
    _rel_close(got_l, want_l)
    _rel_close(got_r, want_r)


def test_composed_pairs_equal_pb():
    """At L=23: the pairs through row 5 plus the bond messages scattered onto
    their receivers equal the plain pb."""
    rng = np.random.RandomState(3)
    ns, B, L, E = 32, 2, 23, 46
    tp = WeightedTensorProduct(FLAGSHIP, SH1, FLAGSHIP)
    lig = torch.as_tensor(rng.randn(B, L, tp.irreps_in.dim).astype(np.float32))
    pos = torch.as_tensor((rng.randn(B, L, 3) * 2).astype(np.float32))
    pair_emb = torch.as_tensor(rng.randn(B, L, L, ns).astype(np.float32))
    pair_mask = torch.as_tensor((rng.rand(B, L, L) > 0.5) & ~np.eye(L, dtype=bool)[None])
    src, dst = (torch.as_tensor(rng.randint(0, L, (B, E))) for _ in range(2))
    bond_emb = torch.as_tensor(rng.randn(B, E, ns).astype(np.float32))
    bond_mask = torch.as_tensor(rng.rand(B, E) > 0.3)
    w = [torch.as_tensor(a) for a in _weights(rng, 3 * ns, 3 * ns, tp.weight_numel)]
    want = tpconv_lig.tpconv_pb_plain(lig, pos, pair_emb, pair_mask, src, dst, bond_emb, bond_mask, *w, FLAGSHIP,
                                      FLAGSHIP, ns)
    scal = lig[..., :ns]
    eattr = torch.cat([pair_emb, scal[:, :, None].expand(B, L, L, ns), scal[:, None].expand(B, L, L, ns)], dim=-1)
    pair_sh = spherical_harmonics(1, pos[:, None] - pos[:, :, None])
    sender = lig[:, None].expand(B, L, L, -1).reshape(B * L, L, -1)
    s_pair = tpconv_v3.fused_tpconv_nbr(eattr.reshape(B * L, L, -1), sender, pair_sh.reshape(B * L, L, 4),
                                        pair_mask.reshape(B * L, L), *w, FLAGSHIP, FLAGSHIP).reshape(B, L, -1)
    eattr_b = torch.cat([bond_emb, gather_nodes(scal, src), gather_nodes(scal, dst)], dim=-1)
    bond_sh = spherical_harmonics(1, gather_nodes(pos, dst) - gather_nodes(pos, src))
    msg_b = tpconv_v3.fused_tpconv_msgs(eattr_b[:, :, None], gather_nodes(lig, dst)[:, :, None], bond_sh[:, :, None],
                                        bond_mask[:, :, None], *w, FLAGSHIP, FLAGSHIP)[:, :, 0]
    s_bond, _ = scatter_mean_to_nodes(msg_b, src, bond_mask, L)
    _rel_close(s_pair + s_bond, want)


def _tiny_models(jb, cross_cap=None):
    jcfg, tcfg = tiny_configs(8)
    if cross_cap is not None:  # as `infer --cross_cap` pins it
        jcfg = dataclasses.replace(jcfg, cross_cap=cross_cap, cross_cap_frac=0.0)
        tcfg = dataclasses.replace(tcfg, cross_cap=cross_cap, cross_cap_frac=0.0)
    jmodel = JaxModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    model = TensorProductScoreModel(tcfg, device="cpu")
    from_flax.load_flax_variables(model, variables)
    return jmodel, variables, model


def _padded(L=None):
    """The padded 1a0q complex (lm 8); with L, its ligand padded to L atoms."""
    if L is None:
        return padded_1a0q(8)
    with open(PKL, "rb") as f:
        hc = pickle.load(f)[0]
    hc = hc._replace(rec_lm=np.random.RandomState(0).randn(len(hc.rec_f), 8).astype(np.float32))
    bucket = jcg.pick_bucket(len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f))._replace(L=L)
    return jcg.pad_complex(hc, bucket, lm_dim=8)


def _count_calls(monkeypatch, calls: dict):
    """Wrap the conv layers' row 4/5/6 wrappers to count their calls."""
    from confidence_bootstrapping_tpu_torch.models import layers

    for name in calls:
        real = getattr(layers, f"fused_tpconv_{name}")

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(layers, f"fused_tpconv_{name}", counted)


@pytest.mark.parametrize("cross_cap,L", [(100, None), (100, 23)])
def test_score_model_composed_routes_match_jax(cross_cap, L, monkeypatch):
    """The tiny score model with the cross cap pinned at 100 (K=100 at
    N=512: rows 4 and 6 instead of cross_rev) and, at L=23, the ligand pairs
    through row 5 instead of pb, against ``model.apply`` with the same
    config."""
    install_jax_score_norms(monkeypatch)
    padded = _padded(L)
    B = 2
    rng = np.random.RandomState(4)
    pos = padded["lig_pos"][None] + rng.randn(B, *padded["lig_pos"].shape).astype(np.float32) * 1.5
    jb = jcg.replicate_complex(padded, B).replace(lig_pos=jax.numpy.asarray(pos)).set_time(0.6, 0.6, 0.6)
    tb = port_batch(jb)
    jmodel, variables, model = _tiny_models(jb, cross_cap)
    assert model.cfg.effective_cross_cap(tb.rec_pos.shape[1]) == 100
    calls = {"cross": 0, "msgs": 0, "nbr": 0}
    _count_calls(monkeypatch, calls)
    want = jax.jit(jmodel.apply)(variables, jb)
    got = model(tb)
    for name in ("tr_pred", "rot_pred", "tor_pred"):
        _rel_close(getattr(got, name).numpy(), getattr(want, name))
    C = model.cfg.num_conv_layers
    assert calls == {"cross": C, "msgs": C - 1, "nbr": 0 if L is None else C + model.cfg.num_prot_emb_layers}


def test_conv_gates_follow_the_jax_routing():
    """conv_pb returns None at L % 8 != 0, conv_cross_rev at K % 16 != 0;
    conv_rec at N % 32 != 0 takes the gathered route with the same sums."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    conv = TPConv(FLAGSHIP, SH1, FLAGSHIP, 96)
    tp = conv.tp
    D = tp.irreps_in.dim
    g = torch.Generator().manual_seed(5)
    lig = torch.randn(1, 23, D, generator=g)
    pos = torch.randn(1, 23, 3, generator=g)
    assert conv.conv_pb(0, lig, pos, torch.zeros(1, 23, 23, 32), torch.zeros(1, 23, 23, dtype=torch.bool),
                        torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4, 32),
                        torch.zeros(1, 4, dtype=torch.bool), 32) is None
    idx = torch.zeros(1, 23, 20, dtype=torch.long)
    assert conv.conv_cross_rev(0, None, lig, pos, lig, pos, idx, torch.zeros(1, 23, 20, 32),
                               torch.ones(1, 23, 20, dtype=torch.bool), 32) is None
    N, K = 40, 6
    node = torch.randn(2, N, D, generator=g)
    npos = torch.randn(2, N, 3, generator=g) * 4
    nbr = torch.randint(0, N, (2, N, K), generator=g)
    emb = torch.randn(2, N, K, 32, generator=g)
    sig = torch.randn(2, 32, generator=g)
    mask = torch.rand(2, N, K, generator=g) > 0.3
    with torch.no_grad():
        got, cnt = conv.conv_rec(0, node, npos, nbr, emb, sig, mask)
        want = tpconv_rec.tpconv_rec_plain(node, npos, nbr, emb, sig, mask, *conv.mlp_weights(0), FLAGSHIP, FLAGSHIP,
                                           32)
    _rel_close(got, want)
    assert torch.equal(cnt, mask.sum(-1).float())


def _phase_cases():
    padded = padded_1a0q(0)
    rng = np.random.RandomState(6)
    blob = (rng.randn(700, 3) * np.array([22.0, 14.0, 9.0])).astype(np.float32)
    mask = np.ones(768, bool)
    mask[700:] = False
    blob_pos = np.concatenate([blob, np.zeros((68, 3), np.float32)])
    return [(padded["rec_pos"], padded["rec_mask"]), (blob_pos, mask),
            (padded["rec_pos"][:128], padded["rec_mask"][:128])]


@pytest.mark.parametrize("steps,margin,dynamic", [(20, 5.0, True), (40, 2.0, True), (7, 5.0, True), (20, 5.0, False)])
def test_derive_phase_plan_matches_jax(steps, margin, dynamic):
    jcfg, tcfg = tiny_configs(0)
    jcfg = dataclasses.replace(jcfg, dynamic_max_cross=dynamic)
    tcfg = dataclasses.replace(tcfg, dynamic_max_cross=dynamic)
    js, ts = JaxSamplerConfig(inference_steps=steps, rec_phase_margin=margin), SamplerConfig(inference_steps=steps,
                                                                                              rec_phase_margin=margin)
    for rec_pos, rec_mask in _phase_cases():
        want = jsampling.derive_phase_plan(jcfg, js, rec_pos, rec_mask)
        got = sampling.derive_phase_plan(tcfg, ts, torch.as_tensor(rec_pos), rec_mask)
        assert got == want
        planned = sampling.with_derived_plan(tcfg, ts, rec_pos, rec_mask)
        assert (planned.rec_phase_steps, planned.rec_phase_caps) == want
    if dynamic and steps == 20:
        assert sampling.derive_phase_plan(tcfg, ts, *_phase_cases()[0])[0]  # 1a0q gets a plan
        fixed = dataclasses.replace(ts, rec_phase_auto=False)
        assert sampling.with_derived_plan(tcfg, fixed, *_phase_cases()[0]) is fixed


@pytest.mark.parametrize("cap,frac", [(100, 0.0), (205, 0.0), (48, 0.2), (100, 0.2)])
def test_effective_cross_cap_matches_jax(cap, frac):
    """A pinned cap (frac 0, as ``infer --cross_cap`` sets it) is min(N, cap)
    at every bucket; a scaled one follows the JAX rounding."""
    jcfg, tcfg = tiny_configs(0)
    jcfg = dataclasses.replace(jcfg, cross_cap=cap, cross_cap_frac=frac)
    tcfg = dataclasses.replace(tcfg, cross_cap=cap, cross_cap_frac=frac)
    for n in (64, 100, 128, 256, 384, 512, 1024, 3072):
        assert tcfg.effective_cross_cap(n) == jcfg.effective_cross_cap(n)
        if not frac:
            assert tcfg.effective_cross_cap(n) == min(n, cap)


@pytest.mark.parametrize("cap,frac", [(100, 0.0), (48, 0.2), (8, 0.0)])
def test_cross_overflow_stats_match_jax(cap, frac):
    jcfg, tcfg = tiny_configs(0)
    jcfg = dataclasses.replace(jcfg, cross_cap=cap, cross_cap_frac=frac)
    tcfg = dataclasses.replace(tcfg, cross_cap=cap, cross_cap_frac=frac)
    padded = padded_1a0q(0)
    rng = np.random.RandomState(7)
    pos = padded["lig_pos"][None] + rng.randn(3, *padded["lig_pos"].shape).astype(np.float32) * 4
    jb = jcg.replicate_complex(padded, 3).replace(lig_pos=jax.numpy.asarray(pos))
    want = jax.device_get(jsampling.cross_overflow_stats(jb, jcfg))
    got = sampling.cross_overflow_stats(port_batch(jb), tcfg)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-6, (k, got[k], want[k])
    if cap == 8:
        assert got["overflow_atom_frac_final"] > 0
