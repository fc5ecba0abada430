"""The host half of the edge backward's tensor-core build, on the CPU.

The build (``csrc/tpconv_bwd.cu``: ``cbt_tpconv_bwd_tc``) numbers the valid
edges in order, recomputes w = h w2c + b2c on 3xTF32 ``wgmma`` from w2c's
packed hi/lo tiles, computes d_w and d_X on the CUDA cores from the tables of
TNC-column tiles, then dh = d_w w2c^T and the weight gradients [h | 1]^T d_w,
[z | 1]^T dh as 3xTF32 products over the compacted rows. The kernels run on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``). Here:
w2c's packed tiles map back to w2c; the tables of TNC-column tiles give the
same d_X as those of TN-column tiles; a float32 emulation of the build's
arithmetic at the score trunk's 74 -> 74 layer and at the torsion head's
20-wide harmonics is within 2e-4 x max(1, max |ref|) per edge and 1e-3 for
the weight sums over about 4096 edges of ``edge_bwd_plain`` in float64;
masked edges get exact zeros and leave the weight sums as they were; the
host mirror of the kernel's shared memory and the layers it takes; and
``chip_smoke``'s spill gate over the build's kernels.
"""

import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu_torch.models.score_model import get_irrep_seq
from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_bwd, tpconv_common as tc
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

TRUNK = "32x0e + 6x1o + 6x1e + 6x0o"  # the score model's 74 -> 74 trunk layer (W = 1660)
TOR_OUT = "32x0o + 32x0e"  # the torsion head's output, with the 20-wide harmonics
REL, SUM_REL = 2e-4, 1e-3


def untile(tiles, H):
    """The inverse of ``tile_w2``: [H, Wpad]."""
    n_tiles, g8, q4 = tiles.shape[:3]
    return tiles.permute(0, 1, 3, 2, 4).reshape(n_tiles * g8 * 8, q4 * 4).t()[:H].contiguous()


def mm3(a, b):
    """a @ b as the tensor cores compute it in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, float32 sums."""
    ah, al = tc.split_tf32(a)
    bh, bl = tc.split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def w2c_of(w2, b2, irreps_in, irreps_out, irreps_sh):
    """w2 and b2 in the backward's canonical column order, 1/sqrt(fan) folded in, padded to TNC-column tiles."""
    lay = tc.tp_layout(irreps_in, irreps_out, irreps_sh, tc.TNC)
    cscale = torch.as_tensor(tpconv_bwd.bwd_layout(irreps_in, irreps_out, irreps_sh, tc.TNC).cscale)
    W = cscale.shape[0]
    w2c, b2c = torch.zeros(w2.shape[0], lay.wpad), torch.zeros(lay.wpad)
    w2c[:, :W], b2c[:W] = w2 * cscale, b2 * cscale
    return w2c, b2c, cscale


def emulate_bwd_tc(attr, x, sh, g, dm, valid, w1, b1, w2, b2, irreps_in, irreps_sh, irreps_out):
    """The tensor-core build's arithmetic in float32: compacted valid rows,
    the recompute from w2c's packed hi/lo tiles and h split the same way,
    d_w (bcol) and d_X (bepi of TNC-column tiles), d_x and d_sh (vtab), the
    3xTF32 products dh = d_w w2c^T and [h | 1]^T d_w, [z | 1]^T dh; per-edge
    outputs scattered back with zeros on the masked edges."""
    lay = tc.tp_layout(irreps_in, irreps_out, irreps_sh)
    bl = tpconv_bwd.bwd_layout(irreps_in, irreps_out, irreps_sh, tc.TNC)
    T, F = attr.shape
    H, W = w2.shape
    rows = torch.arange(T)[valid]
    z, xs, shs, gs = attr[rows], x[rows], sh[rows], g[rows]
    dmr = torch.ones(len(rows), 1) if dm is None else dm[rows]
    w2c, b2c, cscale = w2c_of(w2, b2, irreps_in, irreps_out, irreps_sh)
    w_hi, w_lo = (untile(tc.tile_w2(p), H) for p in tc.split_tf32(w2c))
    h = torch.relu(z @ w1 + b1) * dmr
    h_hi, h_lo = tc.split_tf32(h)
    w = h_lo @ w_hi + h_hi @ w_lo + h_hi @ w_hi + b2c
    X = torch.zeros(len(rows), lay.n_x)
    for s, (in_base, di, sh_base, ds, dout, c, cg_off, _) in enumerate(lay.xtab.tolist()):
        for a in range(di):
            for b in range(ds):
                X[:, s] += xs[:, in_base + a] * shs[:, sh_base + b] * float(lay.cg[cg_off + c + (a * ds + b) * dout])
    bcol = torch.as_tensor(bl.bcol).long()
    d_w = torch.zeros(len(rows), bcol.shape[0])
    for c in range(3):
        on = bcol[:, 2] > c
        d_w[:, on] += gs[:, bcol[on, 1] + c] * X[:, bcol[on, 0] + c]
    dX = torch.zeros_like(X)
    for t in range(len(bl.bepi_start) - 1):
        for lo, hi, gb, step, xi in bl.bepi[bl.bepi_start[t]: bl.bepi_start[t + 1]].tolist():
            n = torch.arange(lo, hi)
            dX[:, xi] += (w[:, t * tc.TNC + n] * gs[:, gb + (n - lo) * step]).sum(-1)
    vec = torch.zeros(len(rows), lay.din + shs.shape[1])
    for o in range(vec.shape[1]):
        other = shs if o < lay.din else xs
        for s, base, n, ci, cs in bl.vtab[bl.vtab_start[o]: bl.vtab_start[o + 1]].tolist():
            coef = sum(other[:, base + q] * float(lay.cg[ci + q * cs]) for q in range(n))
            vec[:, o] += dX[:, s] * coef
    dh = mm3(d_w, w2c.t()) * dmr * (h > 0)
    d_z = dh @ w1.t()
    one = torch.ones(len(rows), 1)
    dw2 = mm3(torch.cat([h, one], 1).t(), d_w)
    dw1 = mm3(torch.cat([z, one], 1).t(), dh)
    out = [torch.zeros(T, F), torch.zeros(T, lay.din), torch.zeros(T, shs.shape[1])]
    for o, v in zip(out, (d_z, vec[:, :lay.din], vec[:, lay.din:])):
        o[rows] = v
    return (*out, dw1[:F], dw1[F], dw2[:H, :W] * cscale, dw2[H, :W] * cscale)


def _case(irreps_in, irreps_sh, irreps_out, T, masked, hd, seed):
    rng = np.random.RandomState(seed)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    F = H = 96
    f32 = lambda *s: torch.as_tensor(rng.randn(*s).astype(np.float32))
    attr, x = f32(T, F), f32(T, tp.irreps_in.dim)
    sh = tc.sh_kernel(f32(T, 3), irreps_sh)
    valid = torch.as_tensor(rng.rand(T) >= masked)
    g = f32(T, tp.irreps_out.dim) * valid[:, None]
    dm = None if hd is None else torch.as_tensor(((rng.rand(T, hd) > 0.1) / 0.9).astype(np.float32))
    w1, b1, w2, b2 = (f32(*s) * 0.2 for s in ((F, H), (H,), (H, tp.weight_numel), (tp.weight_numel,)))
    return attr, x, sh, g, dm, valid, w1, b1, w2, b2


@pytest.mark.parametrize("H", [96, 30])
def test_w2c_tiles_map_back_to_w2c(H):
    rng = np.random.RandomState(1)
    W = WeightedTensorProduct(TRUNK, tc.SH_IRREPS, TRUNK).weight_numel
    w2, b2 = torch.as_tensor(rng.randn(H, W).astype(np.float32)), torch.as_tensor(rng.randn(W).astype(np.float32))
    w2c, b2c, cscale = w2c_of(w2, b2, TRUNK, TRUNK, tc.SH_IRREPS)
    assert w2c.shape[1] % tc.TNC == 0 and float(w2c[:, W:].abs().sum()) == 0.0
    hi, lo = tc.split_tf32(w2c)
    for part in (hi, lo):
        tiles = tc.tile_w2(part)
        assert tiles.shape == (w2c.shape[1] // tc.TNC, tc.TNC // 8, -(-H // 8) * 2, 8, 4)
        assert torch.equal(untile(tiles, H), part)
    assert float(((hi.double() + lo.double()) - w2c.double()).abs().max()) <= 2.0 ** -22 * float(w2c.abs().max())
    assert torch.allclose(w2c[:, :W], w2 * cscale) and torch.equal(b2c[:W], b2 * cscale)


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out", [
    (TRUNK, tc.SH_IRREPS, TRUNK), (TRUNK, tc.TOR_SH_IRREPS, TOR_OUT), ("32x0e", tc.SH_IRREPS, "32x0e + 6x1o")])
def test_tnc_tables_give_the_tn_tables_d_X(irreps_in, irreps_sh, irreps_out):
    """bcol is per column, so the TNC tables' first W rows are the TN
    tables'; bepi cut at TNC columns sums every (segment, component) over the
    same columns as bepi cut at TN columns."""
    a, b = (tpconv_bwd.bwd_layout(irreps_in, irreps_out, irreps_sh, tn) for tn in (tc.TN, tc.TNC))
    W = a.cscale.shape[0]
    assert np.array_equal(a.bcol[:W], b.bcol[:W]) and b.bcol[W:, 2].sum() == 0
    assert np.array_equal(a.vtab, b.vtab) and np.array_equal(a.cscale, b.cscale)
    rng = np.random.RandomState(2)
    lay = tc.tp_layout(irreps_in, irreps_out, irreps_sh)
    wide = max(a.bcol.shape[0], b.bcol.shape[0])
    w, g = rng.randn(5, wide), rng.randn(5, lay.dout)
    for tbl, tn in ((a, tc.TN), (b, tc.TNC)):
        dX = np.zeros((5, lay.n_x))
        for t in range(len(tbl.bepi_start) - 1):
            for lo, hi, gb, step, xi in tbl.bepi[tbl.bepi_start[t]: tbl.bepi_start[t + 1]]:
                n = np.arange(lo, hi)
                dX[:, xi] += (w[:, t * tn + n] * g[:, gb + (n - lo) * step]).sum(-1)
        if tn == tc.TN:
            want = dX
    np.testing.assert_allclose(dX, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out,masked,hd", [
    (TRUNK, tc.SH_IRREPS, TRUNK, 0.19, 96),  # a receptor group: 19% of the slots masked, dropout per hidden unit
    (TRUNK, tc.TOR_SH_IRREPS, TOR_OUT, 0.55, 1),  # an edge list: 55% masked, one dropout value an edge
])
def test_tensor_core_build_emulation_matches_plain(irreps_in, irreps_sh, irreps_out, masked, hd):
    """The build's arithmetic over 4096 edges against autograd of the plain
    per-edge messages in float64: per-edge gradients within 2e-4 x max(1,
    max |ref|), weight sums within 1e-3 x max(1, max |ref|)."""
    args = _case(irreps_in, irreps_sh, irreps_out, 4096, masked, hd, seed=3)
    attr, x, sh, g, dm, valid, w1, b1, w2, b2 = args
    got = emulate_bwd_tc(*args, irreps_in, irreps_sh, irreps_out)
    d = lambda t: None if t is None else t.double()
    want = tpconv_bwd.edge_bwd_plain(d(attr), d(x), d(sh), d(g), d(dm), d(w1), d(b1), d(w2), d(b2), irreps_in,
                                     irreps_sh, irreps_out)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(1.0, float(b.abs().max()))
        assert float((a.double() - b).abs().max()) <= (REL if i < 3 else SUM_REL) * scale, (i, scale)


def test_masked_edges_get_zeros_and_leave_the_weight_sums():
    """Masked edges carry a zero cotangent: the build gives them exact zeros,
    and leaving them out of the compacted rows changes no weight sum beyond
    float32 rounding of the products' other blocking."""
    args = list(_case(TRUNK, tc.SH_IRREPS, TRUNK, 512, 0.5, 96, seed=4))
    valid = args[5]
    skip = emulate_bwd_tc(*args, TRUNK, tc.SH_IRREPS, TRUNK)
    for out in skip[:3]:
        assert float(out[~valid].abs().max()) == 0.0
    args[5] = torch.ones_like(valid)
    every = emulate_bwd_tc(*args, TRUNK, tc.SH_IRREPS, TRUNK)
    for out in every[:3]:
        assert float(out[~valid].abs().max()) == 0.0  # a zero cotangent gives zeros on the edge anyway
    for a, b in zip(skip, every):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max()))


def test_edge_bwd_on_cpu_takes_the_mask_and_runs_the_plain_version():
    args = _case(TRUNK, tc.SH_IRREPS, TRUNK, 40, 0.3, None, seed=5)
    attr, x, sh, g, dm, valid, w1, b1, w2, b2 = args
    ins = (attr, x, sh, g, dm, w1, b1, w2, b2, TRUNK, tc.SH_IRREPS, TRUNK)
    for a, b in zip(tpconv_bwd.edge_bwd(*ins, valid=valid), tpconv_bwd.edge_bwd_plain(*ins)):
        assert torch.equal(a, b)


def test_tensor_core_build_layout_and_the_layers_it_takes():
    """226,816 dynamic bytes at the 74 -> 74 trunk layer (plus the kernel's
    2,768 static, under 232,448); every layer the ns=32 score model trains by
    default (pseudoscalars reduced: the ladder, the torsion head, the center
    conv) takes the build, no layer of the ns=48 ladder (H = 144) does, and
    neither does the unreduced 100 -> 100 layer (S = 340: 286,720 bytes),
    which keeps the float32 builds."""
    def dims(F, H, a, b, sh):  # the layout's arguments at layer a -> b
        lay = tc.tp_layout(a, b, sh)
        n_vtab = len(tpconv_bwd.bwd_layout(a, b, sh).vtab)
        return F, H, lay.din, tc.sh_dim(sh), lay.dout, lay.n_x, len(lay.cg), n_vtab

    assert tpconv_bwd.bwd_tc_smem_bytes(*dims(96, 96, TRUNK, TRUNK, tc.SH_IRREPS)) == 226_816
    for ns, nv, H in ((32, 6, 96), (48, 10, 144)):
        seq = get_irrep_seq(ns, nv, True)
        pairs = [(seq[min(i, 3)], seq[min(i + 1, 3)], tc.SH_IRREPS, H) for i in range(4)]
        pairs += [(seq[3], f"{ns}x0o + {ns}x0e", tc.TOR_SH_IRREPS, H), (seq[3], "2x1o + 2x1e", tc.SH_IRREPS, 2 * ns)]
        for a, b, sh, F in pairs:
            on_tc = tpconv_bwd.bwd_on_tensor_cores(*dims(F, H, a, b, sh))
            assert on_tc == (ns == 32), (a, b, sh)
            if on_tc:
                assert tpconv_bwd.bwd_tc_smem_bytes(*dims(F, H, a, b, sh)) + tpconv_bwd.BWD_TC_STATIC <= \
                    tc.SMEM_LIMIT
    full = "32x0e + 6x1o + 6x1e + 32x0o"
    assert tpconv_bwd.bwd_tc_smem_bytes(*dims(96, 96, full, full, tc.SH_IRREPS)) == 286_720
    assert not tpconv_bwd.bwd_on_tensor_cores(*dims(96, 96, full, full, tc.SH_IRREPS))
    odd = "10x0e + 2x1o + 2x1e + 2x0o"
    assert tpconv_bwd.bwd_on_tensor_cores(*dims(30, 30, odd, odd, tc.SH_IRREPS))  # H not a multiple of 8


def test_row_4_takes_the_tensor_core_stage_at_ns_32_only():
    """fused_tpconv_cross's layers: the tensor-core stage at the ns=32
    ladder (one receiver a block at K=100), the float32 builds at ns=48."""
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_g import cross_rows_per_block

    rt = cross_rows_per_block(100)
    for ns, nv, want in ((32, 6, True), (48, 10, False)):
        seq = get_irrep_seq(ns, nv, True)
        for a, b in [(seq[min(i, 3)], seq[min(i + 1, 3)]) for i in range(4)]:
            lay = tc.tp_layout(a, b)
            d = tc.Dims(ns, ns, 3 * ns, 3 * ns, lay.din, lay.dout)
            assert tc.pick_build("cross", a, b, tc.SH_IRREPS, d, rt, True, (tc.TM, tc.TM_WIDE))[0] == want


def _ptxas(names_spills):
    """A ptxas log of kernels with the given spill-store bytes, as nvcc -Xptxas -v prints it."""
    return "\n".join(f"ptxas info    : Function properties for {n}\n    0 bytes stack frame, {b} bytes spill stores, "
                     f"{b} bytes spill loads" for n, b in names_spills)


def test_spill_gate_names_every_tensor_core_kernel():
    """chip_smoke's spill gate finds the edge backward's per-edge kernel,
    whose name holds TPWeightsTC only inside BwdArgsTC, and both products;
    it fails where one of them is missing from the log or spills, and takes
    no note of a float32 kernel's spill."""
    import chip_smoke

    tpw = "PKfN3cbt11TPWeightsTCENS5_8TPTablesE"
    bwd = ["_ZN46_GLOBAL__N__a_13_tpconv_bwd_cu_b25tpconv_bwd_edge_tc_kernelENS_9BwdArgsTCE",
           "_ZN46_GLOBAL__N__a_13_tpconv_bwd_cu_b17tn_gemm_tc_kernelILi96ELb0EEEvNS_7OperandES1_iiPKiS3_Pfii",
           "_ZN46_GLOBAL__N__a_13_tpconv_bwd_cu_b17tn_gemm_tc_kernelILi96ELb1EEEvNS_7OperandES1_iiPKiS3_Pfii"]
    f32 = ("_ZN46_GLOBAL__N__a_13_tpconv_bwd_cu_b22tpconv_bwd_edge_kernelENS_7BwdArgsE", 40)
    logs = {lib: _ptxas([(f"_Z{k}{tpw}", 0) for k in kernels] + [(f"_Z99{lib}_wide_kernelN3cbt9TPWeightsE", 8)])
            for lib, kernels in chip_smoke.TC_KERNELS.items() if lib != "tpconv_bwd"}
    logs["tpconv_bwd"] = _ptxas([(n, 0) for n in bwd] + [f32])
    spills = chip_smoke.tc_spills(logs)
    assert sorted(spills["tpconv_bwd"]) == sorted(bwd)
    chip_smoke.check_tc_spills(spills)
    for broken in (_ptxas([(n, 0) for n in bwd[1:]] + [f32]), _ptxas([(bwd[0], 16)] + [(n, 0) for n in bwd[1:]])):
        with pytest.raises(SystemExit):
            chip_smoke.check_tc_spills(chip_smoke.tc_spills({**logs, "tpconv_bwd": broken}))
