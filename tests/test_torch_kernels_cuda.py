"""The CUDA TP-conv kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them. They reach what the main path's fixed buckets do not: ragged
receiver tiles, a K that spans several 64-edge chunks or is not a multiple of
16 (or is 1), wholly masked tiles and batch elements, input and output irreps
that differ (the embedding layers), lmax=2 harmonics (the confidence model's
rec_g and cross_g kernels), the training kernels (the edge-list forward with
and without a dropout mask, rec and rec_g with one, the edge backward) and
the autograd ops over them, the composed route's kernels (the one-direction
cross kernel at K off the 16-grid, the edge-list kernel's inference instance
for sums and per-edge messages, the v1 API over it, and TPConv's routing to
them), the legacy models' per-edge messages with edge weights, and the
wrappers' input checks. The rec (with and without the
dropout mask), pb, cross_rev, rec_g, row 4 and edge-list kernels run the
H -> W product on the tensor cores (3xTF32) at the score model's ns=32
layers: their cases include the full-width 100 -> 100 layer, H not a
multiple of 8, the torsion head's 20-wide harmonics, dropout masks of one
value per hidden unit and per edge (rec_g's training variant on its
tensor-core build at the confidence model's trunk layer, and on its float32
build above H = 96), and the outputs of rec, pb, rec_g, row 4
and the edge-list kernel bit for bit across two launches. Layers that stage
does not take (H above 96, a layout over a block's shared memory, the
ns=48/nv=10 ladder) run the float32 builds at 32 edges a chunk, rec_g's
too, and so do the training kernels' layers whose 64-edge layout
does not fit; the edge backward runs at H up to 192, and on its
tensor-core build (H <= 96) skips the masked edges it is told of, giving
them exact zeros, bit for bit across launches, as row 4 is. The
second-order irreps ladder's l = 2 node blocks (5-component input and output
blocks in the CG stage, the X table and the backward's d_w) run on the
edge-list kernel, rec_g with and without the mask, cross_g and the edge
backward, and rec_g and cross_g at lmax=1 (their SHD=4 builds, the general
route). Every library's shared-memory bytes equal the host mirror's. Tolerance:
max |kernel - plain| <= 2e-4 * max(1, max |plain|), the JAX package's kernel
bar; the backward's weight gradients, sums over every edge in another order
than the plain version's, at 1e-3 * max(1, max |plain|). The plain versions
are held against the Pallas kernels by tests/test_torch_tpconv.py and
tests/test_torch_train_ops.py.

Run on the card from the repository root (tests/conftest.py imports JAX,
which the card's machine does not have, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from confidence_bootstrapping_tpu_torch.ops.cuda import (tpconv, tpconv_bwd, tpconv_common, tpconv_edge, tpconv_g,
                                                          tpconv_lig, tpconv_rec, tpconv_train, tpconv_v3)
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

pytestmark = pytest.mark.cuda

FLAGSHIP = "32x0e + 6x1o + 6x1e + 6x0o"
FULL = "32x0e + 6x1o + 6x1e + 32x0o"  # the 100 -> 100 trunk layer, pseudoscalars unreduced (W=2960, 62 tiles)
WIDE_SEQ = ("48x0e", "48x0e + 10x1o", "48x0e + 10x1o + 10x1e", "48x0e + 10x1o + 10x1e + 48x0o")  # ns=48, nv=10
WIDE = WIDE_SEQ[3]  # its 156 -> 156 trunk layer (W=6928, H=144)
ODD_H = "10x0e + 2x1o + 2x1e + 2x0o"  # ns=10: H=30, not a multiple of 8
CONF_TRUNK = "24x0e + 6x1o + 6x1e + 24x0o"
SH1, SH2 = "1x0e + 1x1o", "1x0e + 1x1o + 1x2e"
REL = 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _weights(g, irreps_in, irreps_out, ns, dev, sh=SH1, H=None):
    W = WeightedTensorProduct(irreps_in, sh, irreps_out).weight_numel
    H = H or 3 * ns
    shapes = ((3 * ns, H), (H,), (H, W), (W,))
    return [(torch.randn(s, generator=g) * 0.2).to(dev) for s in shapes]


def _close(got, want, rel=REL):
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    scale = max(1.0, float(want.detach().abs().max()))
    err = float((got.detach() - want.detach()).abs().max())
    assert err <= rel * scale, (err, scale)


def _ns(irreps):
    return int(irreps.split("x")[0])


@pytest.mark.parametrize("irreps_in,irreps_out,B,N,K,masked", [
    ("32x0e", "32x0e + 6x1o", 1, 37, 24, False),  # the first embedding layer, a ragged last tile
    (FLAGSHIP, FLAGSHIP, 2, 19, 7, True),  # K not a multiple of 16, a wholly masked tile
    ("16x0e + 4x1o + 4x1e", "16x0e + 4x1o + 4x1e + 4x0o", 3, 24, 40, False),  # chunks straddle receivers
    (FULL, FULL, 2, 512, 24, False),  # the sample's full-width layer
    (ODD_H, ODD_H, 2, 21, 13, True),  # H=30 padded to 32; 104 candidates a tile, a partial chunk
])
def test_rec_kernel_matches_plain(dev, irreps_in, irreps_out, B, N, K, masked):
    g = _gen(0)
    ns = _ns(irreps_in)
    D = WeightedTensorProduct(irreps_in, "1x0e + 1x1o", irreps_out).irreps_in.dim
    node = torch.randn(B, N, D, generator=g)
    pos = torch.randn(B, N, 3, generator=g) * 4
    nbr = torch.randint(0, N, (B, N, K), generator=g)
    emb = torch.randn(B, N, K, ns, generator=g)
    sig = torch.randn(B, ns, generator=g)
    mask = torch.rand(B, N, K, generator=g) > 0.3
    if masked:
        mask[:, 8:16] = False
        mask[-1] = False
    args = [t.to(dev) for t in (node, pos, nbr, emb, sig, mask)] + _weights(g, irreps_in, irreps_out, ns, dev)
    before = tpconv_rec.fused_tpconv_rec.launches
    got = tpconv_rec.fused_tpconv_rec(*args, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    assert tpconv_rec.fused_tpconv_rec.launches == before + 1
    _close(got, tpconv_rec.tpconv_rec_plain(*args, irreps_in, irreps_out, ns))
    if masked:
        assert float(got[:, 8:16].abs().max()) == 0.0 and float(got[-1].abs().max()) == 0.0
    again = tpconv_rec.fused_tpconv_rec(*args, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # the same sums in the same order: bit for bit


@pytest.mark.parametrize("irreps_in,irreps_out,B,L,E", [
    ("32x0e", "32x0e + 6x1o", 2, 13, 30),
    (FLAGSHIP, FLAGSHIP, 3, 24, 48),
    (FULL, FULL, 32, 24, 48),  # the sample's full-width layer and batch: the whole card in one wave
    (ODD_H, ODD_H, 5, 13, 20),  # H=30 padded to 32
])
def test_pb_kernel_matches_plain(dev, irreps_in, irreps_out, B, L, E):
    g = _gen(1)
    ns = _ns(irreps_in)
    D = WeightedTensorProduct(irreps_in, "1x0e + 1x1o", irreps_out).irreps_in.dim
    lig = torch.randn(B, L, D, generator=g)
    pos = torch.randn(B, L, 3, generator=g) * 2
    pair_emb = torch.randn(B, L, L, ns, generator=g)
    pair_mask = (torch.rand(B, L, L, generator=g) > 0.4) & ~torch.eye(L, dtype=torch.bool)
    pair_mask[:, 4:8] = False  # a receiver tile with bond edges only
    pair_mask[-1] = False
    src = torch.randint(0, L, (B, E), generator=g)
    dst = torch.randint(0, L, (B, E), generator=g)
    bond_emb = torch.randn(B, E, ns, generator=g)
    bond_mask = torch.rand(B, E, generator=g) > 0.3
    args = [t.to(dev) for t in (lig, pos, pair_emb, pair_mask, src, dst, bond_emb, bond_mask)]
    args += _weights(g, irreps_in, irreps_out, ns, dev)
    before = tpconv_lig.fused_tpconv_pb.launches
    got = tpconv_lig.fused_tpconv_pb(*args, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    assert tpconv_lig.fused_tpconv_pb.launches == before + 1
    _close(got, tpconv_lig.tpconv_pb_plain(*args, irreps_in, irreps_out, ns))
    again = tpconv_lig.fused_tpconv_pb(*args, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # each bond summed by one block, in edge order: bit for bit


@pytest.mark.parametrize("irreps,B,L,N,K,with_rev", [
    (FLAGSHIP, 2, 13, 19, 5, True),
    (FLAGSHIP, 2, 7, 150, 130, True),  # one receiver's edges span several 64-edge chunks
    ("16x0e + 4x1o + 4x1e + 4x0o", 3, 24, 64, 48, False),
    (FULL, 2, 24, 512, 128, True),  # the sample's full-width layer at its three cross caps
    (FULL, 2, 24, 256, 64, True),
    (FULL, 2, 24, 128, 48, True),
    (ODD_H, 2, 9, 40, 70, True),  # H=30 padded to 32; a full and a partial chunk per receiver
])
def test_cross_rev_kernel_matches_plain(dev, irreps, B, L, N, K, with_rev):
    g = _gen(2)
    ns = _ns(irreps)
    D = WeightedTensorProduct(irreps, "1x0e + 1x1o", irreps).irreps_in.dim
    lig = torch.randn(B, L, D, generator=g)
    lpos = torch.randn(B, L, 3, generator=g) * 2
    rec = torch.randn(B, N, D, generator=g)
    rpos = torch.randn(B, N, 3, generator=g) * 4
    idx = torch.randint(0, N, (B, L, K), generator=g)
    emb = torch.randn(B, L, K, ns, generator=g)
    mask = torch.rand(B, L, K, generator=g) > 0.3
    mask[-1] = False  # a wholly masked batch element: zero sums in both directions
    args = [t.to(dev) for t in (lig, lpos, rec, rpos, idx, emb, mask)] + _weights(g, irreps, irreps, ns, dev)
    rw = _weights(g, irreps, irreps, ns, dev) if with_rev else [None] * 4
    got_l, got_r = tpconv_lig.fused_tpconv_cross_rev(*args, *rw, irreps, irreps, ns)
    torch.cuda.synchronize()
    want_l, want_r = tpconv_lig.tpconv_cross_rev_plain(*args, *rw, irreps, irreps, ns)
    _close(got_l, want_l)
    assert float(got_l[-1].abs().max()) == 0.0
    if with_rev:
        _close(got_r, want_r)
        assert float(got_r[-1].abs().max()) == 0.0
    else:
        assert got_r is None


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = _gen(3)
    B, N, K, ns = 1, 16, 4, 32
    node = torch.randn(B, N, 32, generator=g).to(dev)
    pos = torch.randn(B, N, 3, generator=g).to(dev)
    nbr = torch.randint(0, N, (B, N, K), generator=g).to(dev)
    emb = torch.randn(B, N, K, ns, generator=g).to(dev)
    sig = torch.zeros(B, ns, device=dev)
    mask = torch.ones(B, N, K, dtype=torch.bool, device=dev)
    w = _weights(g, "32x0e", "32x0e", ns, dev)
    before = tpconv_rec.fused_tpconv_rec.launches
    for bad in (dict(nbr=nbr.int()), dict(node=node.double()), dict(pos=pos.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(emb=emb[..., :16])):
        kw = dict(node=node, pos=pos, nbr=nbr, emb=emb, sig=sig, mask=mask) | bad
        with pytest.raises(ValueError):
            tpconv_rec.fused_tpconv_rec(*kw.values(), *w, "32x0e", "32x0e", ns)
    assert tpconv_rec.fused_tpconv_rec.launches == before


def _cross_inputs(g, irreps, B, L, N, K, ns):
    D = WeightedTensorProduct(irreps, SH1, irreps).irreps_in.dim
    return [torch.randn(B, L, D, generator=g), torch.randn(B, L, 3, generator=g) * 2,
            torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
            torch.randint(0, N, (B, L, K), generator=g), torch.randn(B, L, K, ns, generator=g),
            torch.rand(B, L, K, generator=g) > 0.3]


@pytest.mark.parametrize("irreps_in,irreps_out,H", [
    (FULL, FULL, 120),  # H above the tensor-core stage's 96
    (FULL, FULL, 144),
    (WIDE_SEQ[0], WIDE_SEQ[1], 144),  # the ns=48 ladder: over the shared memory at 64 edges a chunk
    (WIDE, WIDE, 144),
])
def test_wide_hidden_layers_run_on_the_float32_builds(dev, irreps_in, irreps_out, H):
    """rec, pb and cross_rev (with and without reverse weights) at layers
    the tensor-core stage does not take: the float32 builds at 32 edges a
    chunk, against the plain versions; rec and pb bit for bit across two
    launches."""
    g = _gen(14)
    ns = _ns(irreps_in)
    D = WeightedTensorProduct(irreps_in, SH1, irreps_out).irreps_in.dim
    d = tpconv_common.Dims(ns, ns, 3 * ns, H, D, WeightedTensorProduct(irreps_in, SH1, irreps_out).irreps_out.dim)
    assert tpconv_common.pick_build("rec", irreps_in, irreps_out, SH1, d, tpconv_rec.RT, True,
                                    (tpconv_common.TM_WIDE,)) == (False, tpconv_common.TM_WIDE)
    B, N, K = 2, 37, 24
    rec = [torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
           torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
           torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3]
    rec = [t.to(dev) for t in rec] + _weights(g, irreps_in, irreps_out, ns, dev, H=H)
    got = tpconv_rec.fused_tpconv_rec(*rec, irreps_in, irreps_out, ns)
    again = tpconv_rec.fused_tpconv_rec(*rec, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    _close(got, tpconv_rec.tpconv_rec_plain(*rec, irreps_in, irreps_out, ns))
    assert torch.equal(got, again)
    L, E = 13, 30
    pb = [torch.randn(B, L, D, generator=g), torch.randn(B, L, 3, generator=g) * 2,
          torch.randn(B, L, L, ns, generator=g), (torch.rand(B, L, L, generator=g) > 0.4) & ~torch.eye(L, dtype=torch.bool),
          torch.randint(0, L, (B, E), generator=g), torch.randint(0, L, (B, E), generator=g),
          torch.randn(B, E, ns, generator=g), torch.rand(B, E, generator=g) > 0.3]
    pb = [t.to(dev) for t in pb] + _weights(g, irreps_in, irreps_out, ns, dev, H=H)
    got = tpconv_lig.fused_tpconv_pb(*pb, irreps_in, irreps_out, ns)
    again = tpconv_lig.fused_tpconv_pb(*pb, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    _close(got, tpconv_lig.tpconv_pb_plain(*pb, irreps_in, irreps_out, ns))
    assert torch.equal(got, again)
    if irreps_in == irreps_out:  # cross_rev reads both tables at one width
        cross = [t.to(dev) for t in _cross_inputs(g, irreps_in, B, 9, 40, 70, ns)]
        cross += _weights(g, irreps_in, irreps_in, ns, dev, H=H)
        for rw in (_weights(g, irreps_in, irreps_in, ns, dev, H=H), [None] * 4):
            got_l, got_r = tpconv_lig.fused_tpconv_cross_rev(*cross, *rw, irreps_in, irreps_in, ns)
            torch.cuda.synchronize()
            want_l, want_r = tpconv_lig.tpconv_cross_rev_plain(*cross, *rw, irreps_in, irreps_in, ns)
            _close(got_l, want_l)
            if rw[0] is not None:
                _close(got_r, want_r)


def test_layout_mirror_matches_each_library(dev):
    """The host mirror of the engine's shared-memory layouts
    (tpconv_common.engine_smem_bytes, tpconv_bwd.bwd_smem_bytes) against the
    bytes each kernel library computes, at both ladders' layers, both stages
    and both chunk sizes, and at the confidence trunk's lmax=2 layers
    (chip_smoke.layout_check, which fails on the first difference)."""
    import chip_smoke

    assert chip_smoke.layout_check() > 0


def test_tpconv_packs_weights_once_and_again_after_a_change(dev):
    """TPConv lays each edge group's weights out for the kernels once, and
    again after load_state_dict or an in-place change; the conv then agrees
    with the plain version of the new weights."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import pack_weights

    g = _gen(4)
    ns, B, N, K = 32, 2, 24, 8
    conv = TPConv(FLAGSHIP, "1x0e + 1x1o", FLAGSHIP, 3 * ns, num_groups=2).to(dev)
    D = conv.tp.irreps_in.dim
    node = torch.randn(B, N, D, generator=g).to(dev)
    pos = (torch.randn(B, N, 3, generator=g) * 4).to(dev)
    nbr = torch.randint(0, N, (B, N, K), generator=g).to(dev)
    emb = torch.randn(B, N, K, ns, generator=g).to(dev)
    sig = torch.zeros(B, ns, device=dev)
    mask = (torch.rand(B, N, K, generator=g) > 0.3).to(dev)
    first = conv.packed_weights(0, node)
    assert conv.packed_weights(0, node) is first and conv.packed_weights(1, node) is not first
    conv.load_state_dict({k: v * 1.5 for k, v in conv.state_dict().items()})
    second = conv.packed_weights(0, node)
    assert second is not first
    with torch.no_grad():
        conv.edge_mlps[0].layers[1].bias.add_(0.25)
    third = conv.packed_weights(0, node)
    assert third is not second
    want = pack_weights(*conv.mlp_weights(0), FLAGSHIP, FLAGSHIP)
    for a, b in zip(third, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        got, _ = conv.conv_rec(0, node, pos, nbr, emb, sig, mask)
        plain = tpconv_rec.tpconv_rec_plain(node, pos, nbr, emb, sig, mask, *conv.mlp_weights(0), FLAGSHIP, FLAGSHIP, ns)
    torch.cuda.synchronize()
    _close(got, plain)


@pytest.mark.parametrize("irreps_in,irreps_out,B,N,K,masked", [
    ("24x0e", "24x0e + 6x1o", 1, 37, 24, False),  # the ladder's first step, a ragged last tile
    (CONF_TRUNK, CONF_TRUNK, 2, 19, 8, True),  # the atom groups' K, N not a multiple of 8, a masked tile
    (CONF_TRUNK, CONF_TRUNK, 2, 13, 1, False),  # K = 1
    (CONF_TRUNK, CONF_TRUNK, 2, 37, 5, False),  # 40 candidates a tile: one partial chunk
    ("24x0e + 6x1o + 6x1e", CONF_TRUNK, 3, 30, 24, True),  # every edge of the last batch element masked
    (CONF_TRUNK, CONF_TRUNK, 4, 256, 24, False),  # the rerank's receptor group after the crop
])
def test_rec_g_kernel_matches_plain(dev, irreps_in, irreps_out, B, N, K, masked):
    g = _gen(5)
    ns = _ns(irreps_in)
    D = WeightedTensorProduct(irreps_in, SH2, irreps_out).irreps_in.dim
    node = torch.randn(B, N, D, generator=g)
    pos = torch.randn(B, N, 3, generator=g) * 4
    pos[:, -2:] = 0.0  # padded atoms sit at the origin
    nbr = torch.randint(0, N, (B, N, K), generator=g)
    emb = torch.randn(B, N, K, ns, generator=g)
    sig = torch.randn(B, ns, generator=g)
    mask = torch.rand(B, N, K, generator=g) > 0.3
    nbr[0, 0, 0], mask[0, 0, 0] = 0, False  # a masked self-edge
    if masked:
        mask[:, 8:16] = False
        mask[-1] = False
    args = [t.to(dev) for t in (node, pos, nbr, emb, sig, mask)] + _weights(g, irreps_in, irreps_out, ns, dev, SH2)
    before = tpconv_g.fused_tpconv_rec_g.launches
    got = tpconv_g.fused_tpconv_rec_g(*args, irreps_in, SH2, irreps_out, ns)
    torch.cuda.synchronize()
    assert tpconv_g.fused_tpconv_rec_g.launches == before + 1
    _close(got, tpconv_g.tpconv_rec_g_plain(*args, irreps_in, SH2, irreps_out, ns))
    if masked:
        assert float(got[:, 8:16].abs().max()) == 0.0 and float(got[-1].abs().max()) == 0.0
    again = tpconv_g.fused_tpconv_rec_g(*args, irreps_in, SH2, irreps_out, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # the same sums in the same order: bit for bit


@pytest.mark.parametrize("irreps,H", [
    (CONF_TRUNK, 120),  # H above the tensor-core stage's 96
    ("32x0e + 8x1o + 8x1e + 32x0o", 96),  # H it takes, a layout over a block's shared memory (232,976 bytes)
    (WIDE, 144),  # the ns=48/nv=10 trunk layer with lmax=2 harmonics
])
def test_rec_g_float32_build_matches_plain(dev, irreps, H):
    """rec_g at layers the tensor-core stage does not take runs its float32
    build at 32 edges a chunk: against the plain version, bit for bit across
    two launches."""
    g = _gen(16)
    ns, B, N, K = _ns(irreps), 2, 37, 24
    D = WeightedTensorProduct(irreps, SH2, irreps).irreps_in.dim
    d = tpconv_common.Dims(ns, ns, 3 * ns, H, D, D)
    assert tpconv_common.pick_build("rec_g", irreps, irreps, SH2, d, tpconv_g.RT_REC, True,
                                    (tpconv_common.TM_WIDE,)) == (False, tpconv_common.TM_WIDE)
    args = [torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
            torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
            torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3]
    args = [t.to(dev) for t in args] + _weights(g, irreps, irreps, ns, dev, SH2, H)
    before = tpconv_g.fused_tpconv_rec_g.launches
    got = tpconv_g.fused_tpconv_rec_g(*args, irreps, SH2, irreps, ns)
    again = tpconv_g.fused_tpconv_rec_g(*args, irreps, SH2, irreps, ns)
    torch.cuda.synchronize()
    assert tpconv_g.fused_tpconv_rec_g.launches == before + 2
    _close(got, tpconv_g.tpconv_rec_g_plain(*args, irreps, SH2, irreps, ns))
    assert torch.equal(got, again)


@pytest.mark.parametrize("irreps,B,L,N,K", [
    (CONF_TRUNK, 2, 13, 19, 5),
    (CONF_TRUNK, 2, 24, 256, 64),  # the ligand <- receptor group after the crop
    (CONF_TRUNK, 2, 24, 300, 32),  # the ligand <- atom group: two receivers per block
    (CONF_TRUNK, 32, 24, 256, 64),  # the rerank's full batch, ligand <- receptor
    (CONF_TRUNK, 32, 24, 2048, 32),  # and ligand <- atom
    ("24x0e + 6x1o", 3, 7, 50, 1),  # K = 1
    ("24x0e", 1, 5, 20, 130),  # one receiver's edges span several 64-edge chunks
])
def test_cross_g_kernel_matches_plain(dev, irreps, B, L, N, K):
    """cross_g on its tensor-core build (every layer of the confidence
    model's ns=24 ladder takes it) against the plain version, bit for bit
    across two launches, exact zeros where every sender is masked."""
    g = _gen(6)
    ns = _ns(irreps)
    D = WeightedTensorProduct(irreps, SH2, irreps).irreps_in.dim
    recv = torch.randn(B, L, D, generator=g)
    rpos = torch.randn(B, L, 3, generator=g) * 2
    src = torch.randn(B, N, D, generator=g)
    spos = torch.randn(B, N, 3, generator=g) * 4
    idx = torch.randint(0, N, (B, L, K), generator=g)
    emb = torch.randn(B, L, K, ns, generator=g)
    mask = torch.rand(B, L, K, generator=g) > 0.3
    idx[0, 0], mask[0, 0] = 0, False  # cropped senders: index 0, false mask
    mask[-1] = False  # a wholly masked batch element: zero sums
    args = [t.to(dev) for t in (recv, rpos, src, spos, idx, emb, mask)] + _weights(g, irreps, irreps, ns, dev, SH2)
    assert tpconv_g.cross_build("tpconv_cross_g", irreps, irreps, SH2, ns, ns, 3 * ns, K) == (True, tpconv_common.TM)
    before = tpconv_g.fused_tpconv_cross_g.launches
    got = tpconv_g.fused_tpconv_cross_g(*args, irreps, SH2, irreps, ns)
    again = tpconv_g.fused_tpconv_cross_g(*args, irreps, SH2, irreps, ns)
    torch.cuda.synchronize()
    assert tpconv_g.fused_tpconv_cross_g.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits on every launch
    _close(got, tpconv_g.tpconv_cross_g_plain(*args, irreps, SH2, irreps, ns))
    assert float(got[-1].abs().max()) == 0.0 and float(got[0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("irreps,H,K,cm", [
    (CONF_TRUNK, 120, 64, 64),  # H above the tensor-core stage's 96: the float32 build at 64 edges a chunk
    (CONF_TRUNK, 120, 32, 64),
    (WIDE, 144, 64, 32),  # the ns=48/nv=10 trunk layer with lmax=2 harmonics: only 32 edges a chunk fit
    (WIDE, 144, 32, 32),
])
def test_cross_g_float32_builds_match_plain(dev, irreps, H, K, cm):
    """cross_g at layers the tensor-core stage does not take: the float32
    builds at 64 and 32 edges a chunk, against the plain version, bit for
    bit across two launches."""
    g = _gen(17)
    ns = _ns(irreps)
    assert tpconv_g.cross_build("tpconv_cross_g", irreps, irreps, SH2, ns, ns, H, K) == (False, cm)
    args = [t.to(dev) for t in _cross_inputs(g, irreps, 2, 11, 90, K, ns)]
    args += _weights(g, irreps, irreps, ns, dev, SH2, H)
    got = tpconv_g.fused_tpconv_cross_g(*args, irreps, SH2, irreps, ns)
    again = tpconv_g.fused_tpconv_cross_g(*args, irreps, SH2, irreps, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, tpconv_g.tpconv_cross_g_plain(*args, irreps, SH2, irreps, ns))


def test_cross_g_build_choice_matches_the_library(dev):
    """The build ``cross_build`` picks for cross_g, from the host mirror of
    the layouts, is the first one that fits by the library's own bytes
    (``cbt_smem_bytes`` plus ``cbt_static_smem_bytes``): at the confidence
    model's ladder (both lists), at H=120 and at the ns=48 ladder."""
    import ctypes

    from confidence_bootstrapping_tpu_torch.ops.cuda import build

    lib = build.load("tpconv_cross_g")
    smem, static = lib.cbt_smem_bytes, lib.cbt_static_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 14, ctypes.c_longlong
    static.argtypes, static.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    TM, TMW = tpconv_common.TM, tpconv_common.TM_WIDE
    seq24 = ("24x0e", "24x0e + 6x1o", "24x0e + 6x1o + 6x1e", CONF_TRUNK)
    layers = [(a, b, 72) for a, b in zip(seq24, seq24[1:] + seq24[3:])] + [(CONF_TRUNK, CONF_TRUNK, 120)]
    layers += [(a, b, 144) for a, b in zip(WIDE_SEQ, WIDE_SEQ[1:] + WIDE_SEQ[3:])]
    for a, b, H in layers:
        ns = _ns(a)
        for K in (64, 32):
            rt = tpconv_g.cross_rows_per_block(K)
            fits = []
            for tc, cm in ((True, TM), (False, TM), (False, TMW)):
                lay = tpconv_common.tp_layout(a, b, SH2, tpconv_common.TNC if tc else tpconv_common.TN)
                d = tpconv_common.Dims(ns, ns, 3 * ns, H, lay.din, lay.dout)
                dyn = smem(int(tc), cm, 9, *d, lay.n_x, lay.n_tiles, len(lay.epi), len(lay.cg), rt)
                if dyn + static(int(tc), cm) <= tpconv_common.SMEM_LIMIT and (H <= tpconv_common.KMAX or not tc):
                    fits.append((tc, cm))
            assert tpconv_g.cross_build("tpconv_cross_g", a, b, SH2, ns, ns, H, K) == fits[0], (a, b, H, K)


def test_tpconv_lmax2_weight_cache_and_kernels(dev):
    """A TPConv with lmax=2 harmonics lays its weights out for the lmax=2
    tables (the cache keys on the harmonics), and its conv_rec and
    conv_cross go through rec_g and cross_g and agree with the plain
    versions."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv
    from confidence_bootstrapping_tpu_torch.ops.cuda.tpconv_common import pack_weights

    g = _gen(7)
    ns, B, N, L, K = 24, 2, 40, 9, 8
    conv = TPConv(CONF_TRUNK, SH2, CONF_TRUNK, 3 * ns, num_groups=2).to(dev)
    D = conv.tp.irreps_in.dim
    node = torch.randn(B, N, D, generator=g).to(dev)
    pos = (torch.randn(B, N, 3, generator=g) * 4).to(dev)
    nbr = torch.randint(0, N, (B, N, K), generator=g).to(dev)
    emb = torch.randn(B, N, K, ns, generator=g).to(dev)
    sig = torch.randn(B, ns, generator=g).to(dev)
    mask = (torch.rand(B, N, K, generator=g) > 0.3).to(dev)
    packed = conv.packed_weights(1, node)
    assert conv.packed_weights(1, node) is packed
    for a, b in zip(packed, pack_weights(*conv.mlp_weights(1), CONF_TRUNK, CONF_TRUNK, SH2)):
        assert torch.equal(a, b)
    assert packed.w2.shape[1] != pack_weights(*conv.mlp_weights(1), CONF_TRUNK, CONF_TRUNK).w2.shape[1]
    lig = torch.randn(B, L, D, generator=g).to(dev)
    lpos = (torch.randn(B, L, 3, generator=g) * 2).to(dev)
    idx = torch.randint(0, N, (B, L, K), generator=g).to(dev)
    cemb = torch.randn(B, L, K, ns, generator=g).to(dev)
    cmask = (torch.rand(B, L, K, generator=g) > 0.3).to(dev)
    rec_before, cross_before = tpconv_g.fused_tpconv_rec_g.launches, tpconv_g.fused_tpconv_cross_g.launches
    with torch.no_grad():
        got, _ = conv.conv_rec(0, node, pos, nbr, emb, sig, mask)
        got_c, _ = conv.conv_cross(1, lig, lpos, node, pos, idx, cemb, cmask, ns)
        plain = tpconv_g.tpconv_rec_g_plain(node, pos, nbr, emb, sig, mask, *conv.mlp_weights(0), CONF_TRUNK, SH2,
                                            CONF_TRUNK, ns)
        plain_c = tpconv_g.tpconv_cross_g_plain(lig, lpos, node, pos, idx, cemb, cmask, *conv.mlp_weights(1),
                                                CONF_TRUNK, SH2, CONF_TRUNK, ns)
    torch.cuda.synchronize()
    assert tpconv_g.fused_tpconv_rec_g.launches == rec_before + 1
    assert tpconv_g.fused_tpconv_cross_g.launches == cross_before + 1
    _close(got, plain)
    _close(got_c, plain_c)


SUM_REL = 1e-3  # weight gradients: sums over every edge, in another order than the plain version's
TOR_OUT = "32x0o + 32x0e"


def _edge_inputs(g, irreps_in, irreps_sh, irreps_out, M, K, F, dev, dropout, H=96):
    D = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out).irreps_in.dim
    dsh = tpconv_common.sh_dim(irreps_sh)
    W = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out).weight_numel
    attr, send, sh = torch.randn(M, K, F, generator=g), torch.randn(M, K, D, generator=g), torch.randn(M, K, dsh, generator=g)
    mask = torch.rand(M, K, generator=g) > 0.3
    mask[: min(M, 3)] = False  # rows with no valid edge
    weights = [torch.randn(s, generator=g) * 0.2 for s in ((F, H), (H,), (H, W), (W,))]
    dmask = (torch.rand(M, K, H, generator=g) > 0.1).float() / 0.9 if dropout else None
    to = lambda t: None if t is None else t.to(dev)
    return [to(t) for t in (attr, send, sh, mask)], [to(w) for w in weights], to(dmask)


@pytest.mark.parametrize("sum_k", [True, False])
@pytest.mark.parametrize("irreps_sh,irreps_out,M,K,dropout", [
    (SH1, FLAGSHIP, 50, 24, False),  # ligand pairs
    (SH1, FLAGSHIP, 9, 128, True),  # ligand <- receptor: one row spans two 64-edge chunks
    (SH2, FLAGSHIP, 7, 5, True),
    (tpconv_common.TOR_SH_IRREPS, TOR_OUT, 33, 24, True),  # the torsion head's 20-wide harmonics
])
def test_edge_kernel_matches_plain(dev, irreps_sh, irreps_out, M, K, dropout, sum_k):
    """The edge-list kernel's tensor-core build (H=96): with the dropout mask
    at one value per hidden unit and per edge, the same bits on a second
    launch, exact zeros on masked edges and on rows with no valid edge."""
    inputs, weights, dmask = _edge_inputs(_gen(7), FLAGSHIP, irreps_sh, irreps_out, M, K, 96, dev, dropout)
    assert tpconv_edge.edge_build(FLAGSHIP, irreps_sh, irreps_out, 96, 96, K) == (True, tpconv_common.TM)
    for dm in ((dmask, dmask[..., :1].contiguous()) if dropout else (None,)):
        before = tpconv_edge.fused_tpconv_edge.launches
        got = tpconv_edge.fused_tpconv_edge(*inputs, *weights, FLAGSHIP, irreps_sh, irreps_out, dmask=dm, sum_k=sum_k)
        again = tpconv_edge.fused_tpconv_edge(*inputs, *weights, FLAGSHIP, irreps_sh, irreps_out, dmask=dm,
                                              sum_k=sum_k)
        torch.cuda.synchronize()
        assert tpconv_edge.fused_tpconv_edge.launches == before + 2
        want = tpconv_edge.tpconv_edge_plain(*inputs, *weights, FLAGSHIP, irreps_sh, irreps_out, dm, sum_k)
        _close(got, want)
        assert torch.equal(got, again)
        assert float(got[:3].abs().max()) == 0.0
        if not sum_k:
            assert float(got[~inputs[3]].abs().max()) == 0.0


@pytest.mark.parametrize("irreps_in,irreps_out,tc", [
    (CONF_TRUNK, CONF_TRUNK, True),  # the legacy all-atom model at ns=24, nv=6 (H=72): the tensor-core build
    ("24x0e", "24x0e + 6x1o", True),  # its first layer
    (WIDE, WIDE, False),  # DiffDock's legacy score model at ns=48, nv=10 (H=144): float32 at 32 edges a chunk
])
def test_legacy_layers_take_the_edge_kernel_with_edge_weights(dev, irreps_in, irreps_out, tc):
    """A legacy layer's per-edge messages at inference (``TPConv(edge_kernel=
    True).messages`` with the smooth edge weights, lmax=2 harmonics): one
    launch of the edge-list kernel, times the weights, against the same
    call on the CPU (the kernel's plain version); the same bits on a second
    call; masked edges exactly zero."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    g = _gen(21)
    ns = _ns(irreps_in)
    layer = TPConv(irreps_in, SH2, irreps_out, 3 * ns, hidden_features=3 * ns, residual=False, edge_kernel=True)
    for p in layer.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.2
    B, M, K = 2, 13, 24
    x = torch.randn(B, M, K, WeightedTensorProduct(irreps_in, SH2, irreps_out).irreps_in.dim, generator=g)
    vec = torch.randn(B, M, K, 3, generator=g)
    from confidence_bootstrapping_tpu_torch.ops.irreps import spherical_harmonics

    sh = spherical_harmonics(2, vec)
    attr = torch.randn(B, M, K, 3 * ns, generator=g)
    mask = torch.rand(B, M, K, generator=g) > 0.3
    w = 0.5 * (torch.cos(torch.rand(B, M, K, generator=g) * 3.1) + 1)
    want = layer.messages(0, x, sh, attr, mask, edge_weight=w)
    layer.to(dev)
    assert layer.edge_build(K) == (tc, tpconv_common.TM if tc else tpconv_common.TM_WIDE)
    before = tpconv_edge.fused_tpconv_edge.launches
    ins = [t.to(dev) for t in (x, sh, attr, mask)]
    got = layer.messages(0, *ins, edge_weight=w.to(dev))
    again = layer.messages(0, *ins, edge_weight=w.to(dev))
    torch.cuda.synchronize()
    assert tpconv_edge.fused_tpconv_edge.launches == before + 2
    _close(got, want)
    assert torch.equal(got, again)
    assert float(got[~ins[3]].abs().max()) == 0.0


def test_training_and_composed_kernels_at_the_wide_ladder(dev):
    """The ns=48/nv=10 trunk layer (156 -> 156, H=144), whose 64-edge layout
    does not fit a block's shared memory: the edge-list kernel (with a
    dropout mask, sums and per-edge messages; and the torsion head's 20-wide
    harmonics), rec with a dropout mask and row 4 run their builds at 32
    edges a chunk and agree with the plain versions."""
    g = _gen(15)
    ns, H = 48, 144
    F = 3 * ns
    for sh, out in ((SH1, WIDE), (tpconv_common.TOR_SH_IRREPS, "48x0o + 48x0e")):
        inputs, weights, dmask = _edge_inputs(g, WIDE, sh, out, 20, 24, F, dev, True, H)
        lay = tpconv_common.tp_layout(WIDE, out, sh)
        d = tpconv_common.Dims(F, 0, F, H, lay.din, lay.dout)
        assert tpconv_common.pick_build("edge", WIDE, out, sh, d, 2, False)[1] == (tpconv_common.TM_WIDE if sh == SH1
                                                                                   else tpconv_common.TM)
        for sum_k in (True, False):
            got = tpconv_edge.fused_tpconv_edge(*inputs, *weights, WIDE, sh, out, dmask=dmask, sum_k=sum_k)
            torch.cuda.synchronize()
            _close(got, tpconv_edge.tpconv_edge_plain(*inputs, *weights, WIDE, sh, out, dmask, sum_k))
    B, N, K = 2, 37, 24
    D = WeightedTensorProduct(WIDE, SH1, WIDE).irreps_in.dim
    rec = [torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
           torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
           torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3]
    rec = [t.to(dev) for t in rec] + _weights(g, WIDE, WIDE, ns, dev)
    dmask = ((torch.rand(B, N, K, H, generator=g) > 0.1).float() / 0.9).to(dev)
    got = tpconv_rec.fused_tpconv_rec(*rec, WIDE, WIDE, ns, dmask=dmask)
    torch.cuda.synchronize()
    _close(got, tpconv_rec.tpconv_rec_plain(*rec, WIDE, WIDE, ns, dmask))
    for a, b in ((WIDE_SEQ[2], WIDE), (WIDE, WIDE)):  # row 4 at 64 edges a chunk (232,312 bytes), then at 32
        cross = [t.to(dev) for t in _cross_inputs(g, a, B, 24, 300, 100, ns)] + _weights(g, a, b, ns, dev)
        got = tpconv_rec.fused_tpconv_cross(*cross, a, b, ns)
        torch.cuda.synchronize()
        _close(got, tpconv_rec.tpconv_cross_plain(*cross, a, b, ns))


@pytest.mark.parametrize("lmax2", [False, True])
def test_rec_kernels_with_dropout_mask_match_plain(dev, lmax2):
    g = _gen(8)
    irreps, sh, ns = (CONF_TRUNK, SH2, 24) if lmax2 else (FLAGSHIP, SH1, 32)
    B, N, K = 2, 37, 24
    D = WeightedTensorProduct(irreps, sh, irreps).irreps_in.dim
    args = [t.to(dev) for t in (torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
                                torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
                                torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3)]
    args += _weights(g, irreps, irreps, ns, dev, sh)
    args[5][1, 8:16] = False  # receivers with no valid edge: zero sums
    wrapper = tpconv_g.fused_tpconv_rec_g if lmax2 else tpconv_rec.fused_tpconv_rec
    if lmax2:  # the confidence model's trunk layer: on the tensor-core stage (tpconv_rec_g_dm_tc_kernel)
        assert tpconv_g.rec_g_build(irreps, sh, irreps, ns, ns, 3 * ns, True) == (True, tpconv_common.TM)
    else:  # the score model's: on the tensor-core stage (tpconv_rec_dm_tc_kernel)
        assert tpconv_rec.rec_build(irreps, irreps, ns, ns, 3 * ns, True) == (True, tpconv_common.TM)
    before = (wrapper.launches, wrapper.dm_launches)
    for hd in (3 * ns, 1):
        dmask = ((torch.rand(B, N, K, hd, generator=g) > 0.1).float() / 0.9).to(dev)
        if lmax2:
            run = lambda: tpconv_g.fused_tpconv_rec_g(*args, irreps, sh, irreps, ns, dmask=dmask)
            want = tpconv_g.tpconv_rec_g_plain(*args, irreps, sh, irreps, ns, dmask)
        else:
            run = lambda: tpconv_rec.fused_tpconv_rec(*args, irreps, irreps, ns, dmask=dmask)
            want = tpconv_rec.tpconv_rec_plain(*args, irreps, irreps, ns, dmask)
        got, again = run(), run()
        torch.cuda.synchronize()
        _close(got, want)
        assert torch.equal(got, again)
        assert float(got[1, 8:16].abs().max()) == 0.0
    assert (wrapper.launches, wrapper.dm_launches) == (before[0], before[1] + 4)  # counted apart from inference


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hd", ["H", 1])
@pytest.mark.parametrize("H", [72, 120])
def test_rec_g_dropout_builds_match_plain(dev, masked, hd, H):
    """rec_g's training variant at the confidence model's 84 -> 84 trunk
    layer: at H = 72 (ns=24) its tensor-core build, at H = 120 (over the
    stage's 96) its float32 build at 64 edges a chunk; with and without
    masked edges (self-edges, cropped senders), a mask value per hidden unit
    and per edge. Against the plain version, bit for bit across launches,
    exact zeros for receivers with no valid edge, counted in dm_launches."""
    g = _gen(21)
    ns, B, N, K = 24, 2, 45, 24
    args = [t.to(dev) for t in (torch.randn(B, N, 84, generator=g), torch.randn(B, N, 3, generator=g) * 4,
                                torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
                                torch.randn(B, ns, generator=g),
                                (torch.rand(B, N, K, generator=g) > 0.3) if masked else torch.ones(B, N, K, dtype=torch.bool))]
    args += _weights(g, CONF_TRUNK, CONF_TRUNK, ns, dev, SH2, H)
    if masked:
        args[5][1, 8:16] = False
    assert tpconv_g.rec_g_build(CONF_TRUNK, SH2, CONF_TRUNK, ns, ns, H, True) == (H <= 96, tpconv_common.TM)
    dmask = ((torch.rand(B, N, K, H if hd == "H" else 1, generator=g) > 0.1).float() / 0.9).to(dev)
    before = (tpconv_g.fused_tpconv_rec_g.launches, tpconv_g.fused_tpconv_rec_g.dm_launches)
    got = tpconv_g.fused_tpconv_rec_g(*args, CONF_TRUNK, SH2, CONF_TRUNK, ns, dmask=dmask)
    again = tpconv_g.fused_tpconv_rec_g(*args, CONF_TRUNK, SH2, CONF_TRUNK, ns, dmask=dmask)
    torch.cuda.synchronize()
    assert (tpconv_g.fused_tpconv_rec_g.launches, tpconv_g.fused_tpconv_rec_g.dm_launches) == (before[0], before[1] + 2)
    _close(got, tpconv_g.tpconv_rec_g_plain(*args, CONF_TRUNK, SH2, CONF_TRUNK, ns, dmask))
    assert torch.equal(got, again)
    if masked:
        assert float(got[1, 8:16].abs().max()) == 0.0


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out,T,masked,hd,H", [
    (FLAGSHIP, SH1, FLAGSHIP, 333, 0.3, "H", 96),  # a ragged last block
    (FLAGSHIP, SH1, FLAGSHIP, 6000, 0.3, None, 96),  # several slices of the weight reduction
    (FLAGSHIP, SH1, FLAGSHIP, 24576, 0.19, "H", 96),  # a full-width receptor group (B=2, N=512, K=24), 19% masked
    (FLAGSHIP, SH1, FLAGSHIP, 9000, 0.55, 1, 96),  # an edge list, 55% masked, one dropout value an edge
    (FLAGSHIP, tpconv_common.TOR_SH_IRREPS, TOR_OUT, 200, 0.3, "H", 96),  # the torsion head's Dsh = 20
    (FLAGSHIP, SH2, FLAGSHIP, 100, 0.3, None, 96),
    (ODD_H, SH1, ODD_H, 500, 0.3, "H", 30),  # H = 30, not a multiple of 8
    (CONF_TRUNK, SH2, CONF_TRUNK, 2000, 0.3, 1, 72),  # H = 72 at lmax = 2
    (WIDE, SH1, WIDE, 333, 0.3, "H", 144),  # the ns=48 trunk layer: the float32 build at 16 edges a block
    (WIDE, SH1, WIDE, 5000, 0.3, None, 144),  # several slices of the float32 builds' weight reduction
    (FLAGSHIP, SH1, FLAGSHIP, 3000, 0.3, 1, 120),  # H = 120: the float32 build at 32 edges a block
    (FLAGSHIP, SH1, FLAGSHIP, 150, 0.3, None, 192),  # H = 192, the widest the 16-edge build takes
])
def test_edge_bwd_kernel_matches_plain(dev, irreps_in, irreps_sh, irreps_out, T, masked, hd, H):
    """The tensor-core build (H <= 96) skips the masked edges it is told of:
    they get exact zeros; every build gives the same bits on a second
    launch."""
    g = _gen(9)
    F = 3 * _ns(irreps_in)
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    W = tp.weight_numel
    attr, send = torch.randn(T, F, generator=g), torch.randn(T, tp.irreps_in.dim, generator=g)
    sh = torch.randn(T, tpconv_common.sh_dim(irreps_sh), generator=g)
    mask = torch.rand(T, generator=g) >= masked
    cot = torch.randn(T, tp.irreps_out.dim, generator=g) * mask[:, None]
    dmask = None if hd is None else (torch.rand(T, H if hd == "H" else hd, generator=g) > 0.1).float() / 0.9
    weights = [(torch.randn(s, generator=g) * 0.2).to(dev) for s in ((F, H), (H,), (H, W), (W,))]
    to = lambda t: None if t is None else t.to(dev).contiguous()
    ins = (to(attr), to(send), to(sh), to(cot), to(dmask), *weights, irreps_in, irreps_sh, irreps_out)
    mask = mask.to(dev)
    before = tpconv_bwd.edge_bwd.launches
    got = tpconv_bwd.edge_bwd(*ins, valid=mask)
    again = tpconv_bwd.edge_bwd(*ins, valid=mask)
    torch.cuda.synchronize()
    assert tpconv_bwd.edge_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tpconv_bwd.edge_bwd_plain(*ins)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, REL if i < 3 else SUM_REL)
    for a in got[:3]:
        assert float(a[~mask].abs().max()) == 0.0


@pytest.mark.parametrize("irreps,H", [(FLAGSHIP, 96), (WIDE, 144)])
def test_edge_bwd_without_valid_takes_every_edge(dev, irreps, H):
    """valid=None (the tensor-core build, H=96; the float32 build, H=144)
    gives the bits of valid=all-true."""
    g = _gen(12)
    T, F = 700, 3 * _ns(irreps)
    tp = WeightedTensorProduct(irreps, SH1, irreps)
    shapes = ((T, F), (T, tp.irreps_in.dim), (T, 4), (T, tp.irreps_out.dim))
    ins = [torch.randn(s, generator=g).to(dev) for s in shapes]
    weights = [(torch.randn(s, generator=g) * 0.2).to(dev) for s in ((F, H), (H,), (H, tp.weight_numel),
                                                                      (tp.weight_numel,))]
    args = (*ins, None, *weights, irreps, SH1, irreps)
    got = tpconv_bwd.edge_bwd(*args)
    every = tpconv_bwd.edge_bwd(*args, valid=torch.ones(T, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, every))


def test_train_ops_match_autograd_of_plain(dev):
    """The autograd ops on the card (edge-list and rec kernels forward, the
    edge backward kernel) against autograd through the plain compositions
    on the card: outputs and every gradient."""
    g = _gen(10)
    inputs, weights, dmask = _edge_inputs(g, FLAGSHIP, SH1, FLAGSHIP, 40, 24, 96, dev, True)
    for sum_k in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in inputs[:3] + weights]
        a = leaves[:3] + [inputs[3]] + leaves[3:]
        out = tpconv_train.fused_tpconv_train(*a, FLAGSHIP, SH1, FLAGSHIP, dmask=dmask, sum_k=sum_k)
        ref = tpconv_edge.tpconv_edge_plain(*a, FLAGSHIP, SH1, FLAGSHIP, dmask, sum_k)
        cot = torch.randn(out.shape, generator=g).to(dev)
        _close(out, ref)
        for i, (x, y) in enumerate(zip(torch.autograd.grad((out * cot).sum(), leaves),
                                       torch.autograd.grad((ref * cot).sum(), leaves))):
            _close(x, y, REL if i < 3 else SUM_REL)
    B, N, K, ns = 2, 40, 24, 32
    # no self-edges: at a zero vector d_pos is a cancellation of ~1e6-sized terms in either version
    nbr = (torch.arange(N)[None, :, None] + torch.randint(1, N, (B, N, K), generator=g)) % N
    rec = [torch.randn(B, N, 74, generator=g), torch.randn(B, N, 3, generator=g) * 4, nbr,
           torch.randn(B, N, K, ns, generator=g),
           torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3]
    rec = [t.to(dev) for t in rec] + _weights(g, FLAGSHIP, FLAGSHIP, ns, dev)
    dmask = ((torch.rand(B, N, K, 3 * ns, generator=g) > 0.1).float() / 0.9).to(dev)
    idx = (0, 1, 3, 4, 6, 7, 8, 9)  # node_attr, pos, edge_emb, sig and the weights
    leaves = [rec[i].clone().requires_grad_(True) for i in idx]
    a = list(rec)
    for i, t in zip(idx, leaves):
        a[i] = t
    out = tpconv_train.fused_tpconv_rec_train(*a, FLAGSHIP, SH1, FLAGSHIP, ns, dmask=dmask)
    ref = tpconv_rec.tpconv_rec_plain(*a, FLAGSHIP, FLAGSHIP, ns, dmask)
    cot = torch.randn(out.shape, generator=g).to(dev)
    _close(out, ref)
    for i, (x, y) in enumerate(zip(torch.autograd.grad((out * cot).sum(), leaves),
                                   torch.autograd.grad((ref * cot).sum(), leaves))):
        _close(x, y, REL if i < 2 else SUM_REL)


@pytest.mark.parametrize("irreps,B,L,N,K", [
    (FLAGSHIP, 2, 13, 150, 40),
    (FLAGSHIP, 2, 24, 512, 100),  # the evaluator's pinned cap: a full 64-edge chunk and a partial one per receiver
    (FLAGSHIP, 32, 24, 512, 100),  # the evaluator's full batch
    (ODD_H, 2, 13, 150, 40),  # H = 30 on the tensor-core stage
    ("16x0e + 4x1o + 4x1e + 4x0o", 2, 9, 300, 205),  # four chunks per receiver, K above 128
])
def test_cross_kernel_matches_plain(dev, irreps, B, L, N, K):
    g = _gen(11)
    ns = _ns(irreps)
    D = WeightedTensorProduct(irreps, SH1, irreps).irreps_in.dim
    recv = torch.randn(B, L, D, generator=g)
    rpos = torch.randn(B, L, 3, generator=g) * 2
    src = torch.randn(B, N, D, generator=g)
    spos = torch.randn(B, N, 3, generator=g) * 4
    idx = torch.randint(0, N, (B, L, K), generator=g)
    emb = torch.randn(B, L, K, ns, generator=g)
    mask = torch.rand(B, L, K, generator=g) > 0.3
    mask[0, 3] = False  # a receiver whose whole list is masked
    mask[-1, -1, -1] = True
    args = [t.to(dev) for t in (recv, rpos, src, spos, idx, emb, mask)] + _weights(g, irreps, irreps, ns, dev)
    before = tpconv_rec.fused_tpconv_cross.launches
    got = tpconv_rec.fused_tpconv_cross(*args, irreps, irreps, ns)
    again = tpconv_rec.fused_tpconv_cross(*args, irreps, irreps, ns)
    torch.cuda.synchronize()
    assert tpconv_rec.fused_tpconv_cross.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits on every launch
    _close(got, tpconv_rec.tpconv_cross_plain(*args, irreps, irreps, ns))
    assert float(got[0, 3].abs().max()) == 0.0
    with pytest.raises(ValueError):  # lmax=2 weights do not fit the lmax=1 kernel's tables
        tpconv_rec.fused_tpconv_cross(*args[:7], *_weights(g, irreps, irreps, ns, dev, SH2), irreps, irreps, ns)


@pytest.mark.parametrize("irreps_in,irreps_out,M,K", [
    (FLAGSHIP, FLAGSHIP, 48, 100),  # the receptor <- ligand lists at the pinned cap
    ("32x0e", "32x0e + 6x1o", 46, 23),  # the ligand pairs at L=23, the first embedding layer
    (FLAGSHIP, FLAGSHIP, 70, 24),  # receptor kNN lists at N % 32 != 0
])
def test_v3_edge_list_kernels_match_plain(dev, irreps_in, irreps_out, M, K):
    g = _gen(12)
    tp = WeightedTensorProduct(irreps_in, SH1, irreps_out)
    F = 96
    attr, send = torch.randn(M, K, F, generator=g), torch.randn(M, K, tp.irreps_in.dim, generator=g)
    sh = tpconv_common.sh1(torch.randn(M, K, 3, generator=g))
    mask = torch.rand(M, K, generator=g) > 0.3
    mask[:3] = False
    weights = [torch.randn(s, generator=g) * 0.2 for s in ((F, F), (F,), (F, tp.weight_numel), (tp.weight_numel,))]
    args = [t.to(dev) for t in (attr, send, sh, mask, *weights)]
    assert tpconv_edge.edge_build(irreps_in, SH1, irreps_out, F, F, K) == (True, tpconv_common.TM)
    before = (tpconv_v3.fused_tpconv_nbr.launches, tpconv_v3.fused_tpconv_msgs.launches,
              tpconv_edge.fused_tpconv_edge.launches)
    got_sum = tpconv_v3.fused_tpconv_nbr(*args, irreps_in, irreps_out, tile_m=8, interpret=True, use_bf16=False)
    got_msg = tpconv_v3.fused_tpconv_msgs(*args, irreps_in, irreps_out)
    again_sum = tpconv_v3.fused_tpconv_nbr(*args, irreps_in, irreps_out)
    again_msg = tpconv_v3.fused_tpconv_msgs(*args, irreps_in, irreps_out)
    torch.cuda.synchronize()
    assert (tpconv_v3.fused_tpconv_nbr.launches, tpconv_v3.fused_tpconv_msgs.launches,
            tpconv_edge.fused_tpconv_edge.launches) == (before[0] + 2, before[1] + 2, before[2])
    _close(got_sum, tpconv_v3.tpconv_nbr_plain(*args, irreps_in, irreps_out))
    _close(got_msg, tpconv_v3.tpconv_msgs_plain(*args, irreps_in, irreps_out))
    assert torch.equal(got_sum, again_sum) and torch.equal(got_msg, again_msg)
    assert float(got_msg[~args[3]].abs().max()) == 0.0 and float(got_sum[:3].abs().max()) == 0.0
    with pytest.raises(ValueError):  # the v3 wrappers take lmax=1 harmonics only
        tpconv_v3.fused_tpconv_nbr(args[0], args[1], torch.zeros(M, K, 9, device=dev), *args[3:], irreps_in,
                                   irreps_out)
    v1_sum = tpconv.fused_tpconv_nbr(*args, irreps_in, irreps_out, tile_m=8, debug_stage=0)
    v1_msg = tpconv.fused_tpconv_msgs(*args, irreps_in, irreps_out)
    torch.cuda.synchronize()
    _close(v1_sum, got_sum)
    _close(v1_msg, got_msg)


def test_tpconv_composed_routes_on_the_card(dev):
    """TPConv at lmax=1 in inference: conv_cross launches row 4, conv_nbr row
    5, msgs_nbr row 6, conv_rec at N % 32 != 0 row 5 (not rec); each agrees
    with the plain version of the same function."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    g = _gen(13)
    ns, B, N, L, K = 32, 2, 40, 9, 20
    conv = TPConv(FLAGSHIP, SH1, FLAGSHIP, 3 * ns, num_groups=2).to(dev)
    D = conv.tp.irreps_in.dim
    node = torch.randn(B, N, D, generator=g).to(dev)
    pos = (torch.randn(B, N, 3, generator=g) * 4).to(dev)
    nbr = torch.randint(0, N, (B, N, 24), generator=g).to(dev)
    emb = torch.randn(B, N, 24, ns, generator=g).to(dev)
    sig = torch.randn(B, ns, generator=g).to(dev)
    mask = (torch.rand(B, N, 24, generator=g) > 0.3).to(dev)
    lig = torch.randn(B, L, D, generator=g).to(dev)
    lpos = (torch.randn(B, L, 3, generator=g) * 2).to(dev)
    idx = torch.randint(0, N, (B, L, K), generator=g).to(dev)
    cemb = torch.randn(B, L, K, ns, generator=g).to(dev)
    cmask = (torch.rand(B, L, K, generator=g) > 0.3).to(dev)
    counters = (tpconv_rec.fused_tpconv_cross, tpconv_v3.fused_tpconv_nbr, tpconv_v3.fused_tpconv_msgs,
                tpconv_rec.fused_tpconv_rec, tpconv_lig.fused_tpconv_cross_rev)
    before = [c.launches for c in counters]
    with torch.no_grad():
        assert conv.conv_cross_rev(1, 0, lig, lpos, node, pos, idx, cemb, cmask, ns) is None
        got_c, _ = conv.conv_cross(1, lig, lpos, node, pos, idx, cemb, cmask, ns)
        got_r, _ = conv.conv_rec(0, node, pos, nbr, emb, sig, mask)
        eattr = torch.randn(B, L, K, 3 * ns, generator=g).to(dev)
        sh = tpconv_common.sh1(torch.randn(B, L, K, 3, generator=g).to(dev))
        sender = node[:, None, :K].expand(B, L, K, D)
        got_m = conv.msgs_nbr(0, sender, sh, eattr, cmask)
        plain_c = tpconv_rec.tpconv_cross_plain(lig, lpos, node, pos, idx, cemb, cmask, *conv.mlp_weights(1),
                                                FLAGSHIP, FLAGSHIP, ns)
        plain_r = tpconv_rec.tpconv_rec_plain(node, pos, nbr, emb, sig, mask, *conv.mlp_weights(0), FLAGSHIP,
                                              FLAGSHIP, ns)
        plain_m = tpconv_v3.tpconv_msgs_plain(eattr, sender, sh, cmask, *conv.mlp_weights(0), FLAGSHIP, FLAGSHIP)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0]
    _close(got_c, plain_c)
    _close(got_r, plain_r)
    _close(got_m, plain_m)


def test_dock_cli_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch):
    """``cli/dock.main`` from PDB and SDF files at a tiny config (ns=8, 3
    steps, 4 poses, a tiny all-atom confidence model): on the card, every
    TP-conv through its kernel, and its poses within 1e-2 A of the same call
    on the CPU (the sampler's card-against-CPU tolerance) with the prior's
    and the steps' draws injected, its confidences within 1e-3 x max(1,
    max |cpu|)."""
    import os

    import numpy as np

    from confidence_bootstrapping_tpu_torch.cli import dock
    from confidence_bootstrapping_tpu_torch.config import ScoreModelConfig, confidence_model_config
    from confidence_bootstrapping_tpu_torch.models.factory import get_model
    from confidence_bootstrapping_tpu_torch.sampler import sampling
    from confidence_bootstrapping_tpu_torch.train.checkpoints import save_model_dir
    from test_torch_files import write_complex

    prot, lig = write_complex(str(tmp_path), "c0", seed=5, n_res=60)
    dirs = {}
    for name, cfg in (("score", ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1,
                                                 lm_embedding_dim=0)),
                      ("conf", confidence_model_config(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=0))):
        dirs[name] = str(tmp_path / name)
        save_model_dir(dirs[name], cfg, get_model(cfg, device="cpu"))
    rng = np.random.RandomState(9)
    draws = {}

    def draw(key, shape, device):
        if key not in draws:
            draws[key] = rng.randn(*shape).astype(np.float32)
        return torch.as_tensor(draws[key], device=device)

    real_prior, real_step = sampling.randomize_position, sampling.reverse_diffusion_step

    def prior(batch, generator, tr_sigma_max, *a, **k):
        B, R, d = batch.batch_size, batch.tor_src.shape[1], batch.lig_pos.device
        return real_prior(batch, generator, tr_sigma_max, *a, tor_u=draw("tor", (B, R), d), rot_q=draw("rot", (B, 4), d),
                          tr_z=draw("tr", (B, 3), d), **k)

    def step(model, batch, rec_cache, i, *a, **k):
        B, R, d = batch.batch_size, batch.tor_src.shape[1], batch.lig_pos.device
        return real_step(model, batch, rec_cache, i, *a, tr_z=draw(("tr", i), (B, 3), d),
                         rot_z=draw(("rot", i), (B, 3), d), tor_z=draw(("tor", i), (B, R), d), **k)

    monkeypatch.setattr(sampling, "randomize_position", prior)
    monkeypatch.setattr(sampling, "reverse_diffusion_step", step)
    counters = (tpconv_rec.fused_tpconv_rec, tpconv_lig.fused_tpconv_pb, tpconv_g.fused_tpconv_rec_g,
                tpconv_g.fused_tpconv_cross_g)
    out = {}
    for device in ("cuda", "cpu"):  # the card first: it builds the score-norm tables
        before = [c.launches for c in counters]
        out[device] = dock.main(["--protein_path", prot, "--ligand", lig, "--samples", "4", "--batch_size", "4",
                                 "--inference_steps", "3", "--model_dir", dirs["score"], "--confidence_model_dir",
                                 dirs["conf"], "--out_dir", str(tmp_path / device), "--device", device])
        torch.cuda.synchronize()
        if device == "cuda":
            assert all(c.launches > b for c, b in zip(counters, before))
        assert len([f for f in os.listdir(tmp_path / device / "c0_ligand") if f.startswith("rank")]) == 4
    (pos, conf), (pos_cpu, conf_cpu) = out["cuda"], out["cpu"]
    assert np.isfinite(pos).all() and np.abs(pos - pos_cpu).max() <= 1e-2
    assert np.abs(conf - conf_cpu).max() <= 1e-3 * max(1.0, np.abs(conf_cpu).max())


# ----------------------------------------------------------------------------- l = 2 node blocks (the second-order
# irreps ladder) and the general route's lmax=1 (SHD=4) builds of rec_g and cross_g

SECOND = ("32x0e", "32x0e + 6x1o + 6x2e", "32x0e + 6x1o + 6x2e + 6x1e + 6x2o",
          "32x0e + 6x1o + 6x2e + 6x1e + 6x2o + 6x0o")  # ns=32, nv=6: 32 -> 80 -> 128 -> 134 -> 134
SECOND_LAYERS = [(SECOND[0], SECOND[1]), (SECOND[1], SECOND[2]), (SECOND[2], SECOND[3]), (SECOND[3], SECOND[3])]


@pytest.mark.parametrize("sum_k", [True, False])
@pytest.mark.parametrize("layer,irreps_sh,dropout", [(1, SH1, False), (3, SH1, True), (1, SH2, True), (3, SH2, False),
                                                      (3, tpconv_common.TOR_SH_IRREPS, True)])
def test_edge_kernel_at_l2_node_blocks_matches_plain(dev, layer, irreps_sh, dropout, sum_k):
    """Row 7 at the second-order ladder's layers (input blocks of 5
    components in the CG stage; the torsion head's 20-wide harmonics too): on
    whichever build the layer fits, the same bits on a second launch, masked
    edges exactly zero."""
    irreps_in, irreps_out = SECOND_LAYERS[layer]
    if irreps_sh == tpconv_common.TOR_SH_IRREPS:
        irreps_out = TOR_OUT
    inputs, weights, dmask = _edge_inputs(_gen(31), irreps_in, irreps_sh, irreps_out, 11, 24, 96, dev, dropout)
    tc, cm = tpconv_edge.edge_build(irreps_in, irreps_sh, irreps_out, 96, 96, 24)
    before = tpconv_edge.fused_tpconv_edge.launches
    got = tpconv_edge.fused_tpconv_edge(*inputs, *weights, irreps_in, irreps_sh, irreps_out, dmask=dmask, sum_k=sum_k)
    again = tpconv_edge.fused_tpconv_edge(*inputs, *weights, irreps_in, irreps_sh, irreps_out, dmask=dmask, sum_k=sum_k)
    torch.cuda.synchronize()
    assert tpconv_edge.fused_tpconv_edge.launches == before + 2
    _close(got, tpconv_edge.tpconv_edge_plain(*inputs, *weights, irreps_in, irreps_sh, irreps_out, dmask, sum_k))
    assert torch.equal(got, again), (tc, cm)
    assert float(got[:3].abs().max()) == 0.0
    if not sum_k:
        assert float(got[~inputs[3]].abs().max()) == 0.0


@pytest.mark.parametrize("layer,irreps_sh,hd", [(0, SH1, None), (1, SH1, "H"), (3, SH1, None), (3, SH1, "H"),
                                                (3, SH1, 1), (1, SH2, None), (3, SH2, "H")])
def test_rec_g_at_l2_node_blocks_and_lmax1_matches_plain(dev, layer, irreps_sh, hd):
    """Row 8 with and without the dropout mask at the second-order ladder's
    layers: lmax=1 runs the SHD=4 builds (the general route at lmax=1),
    lmax=2 the SHD=9 ones; the widest layers take the float32 builds at
    TM_WIDE edges a chunk. Bit for bit across launches, exact zeros for
    receivers with no valid edge, counted apart with and without the mask."""
    irreps_in, irreps_out = SECOND_LAYERS[layer]
    g = _gen(33)
    ns, B, N, K = 32, 2, 45, 24
    D = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out).irreps_in.dim
    args = [t.to(dev) for t in (torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
                                torch.randint(0, N, (B, N, K), generator=g), torch.randn(B, N, K, ns, generator=g),
                                torch.randn(B, ns, generator=g), torch.rand(B, N, K, generator=g) > 0.3)]
    args[5][1, 8:16] = False
    args += _weights(g, irreps_in, irreps_out, ns, dev, irreps_sh)
    dmask = None if hd is None else ((torch.rand(B, N, K, 96 if hd == "H" else 1, generator=g) > 0.1).float()
                                     / 0.9).to(dev)
    before = (tpconv_g.fused_tpconv_rec_g.launches, tpconv_g.fused_tpconv_rec_g.dm_launches)
    got = tpconv_g.fused_tpconv_rec_g(*args, irreps_in, irreps_sh, irreps_out, ns, dmask=dmask)
    again = tpconv_g.fused_tpconv_rec_g(*args, irreps_in, irreps_sh, irreps_out, ns, dmask=dmask)
    torch.cuda.synchronize()
    n = (2, 0) if dmask is None else (0, 2)
    assert (tpconv_g.fused_tpconv_rec_g.launches, tpconv_g.fused_tpconv_rec_g.dm_launches) == (before[0] + n[0],
                                                                                               before[1] + n[1])
    _close(got, tpconv_g.tpconv_rec_g_plain(*args, irreps_in, irreps_sh, irreps_out, ns, dmask))
    assert torch.equal(got, again)
    assert float(got[1, 8:16].abs().max()) == 0.0


@pytest.mark.parametrize("layer,irreps_sh,B,L,N,K", [(0, SH1, 2, 24, 512, 128), (1, SH1, 2, 24, 300, 32),
                                                     (3, SH1, 32, 24, 512, 128), (3, SH1, 3, 7, 50, 1),
                                                     (1, SH2, 2, 24, 256, 64), (3, SH2, 2, 13, 19, 5)])
def test_cross_g_at_l2_node_blocks_and_lmax1_matches_plain(dev, layer, irreps_sh, B, L, N, K):
    """Row 9 at the second-order ladder's layers, lmax=1 (SHD=4: the ligand
    <- receptor lists of the residue-level model's general route, K up to
    the 1a0q bucket's cap 128) and lmax=2; bit for bit across launches."""
    irreps_in, irreps_out = SECOND_LAYERS[layer]
    g = _gen(35)
    ns = 32
    D = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out).irreps_in.dim
    args = [t.to(dev) for t in (torch.randn(B, L, D, generator=g), torch.randn(B, L, 3, generator=g) * 2,
                                torch.randn(B, N, D, generator=g), torch.randn(B, N, 3, generator=g) * 4,
                                torch.randint(0, N, (B, L, K), generator=g), torch.randn(B, L, K, ns, generator=g),
                                torch.rand(B, L, K, generator=g) > 0.3)]
    args[6][-1] = False
    args += _weights(g, irreps_in, irreps_out, ns, dev, irreps_sh)
    before = tpconv_g.fused_tpconv_cross_g.launches
    got = tpconv_g.fused_tpconv_cross_g(*args, irreps_in, irreps_sh, irreps_out, ns)
    again = tpconv_g.fused_tpconv_cross_g(*args, irreps_in, irreps_sh, irreps_out, ns)
    torch.cuda.synchronize()
    assert tpconv_g.fused_tpconv_cross_g.launches == before + 2
    assert torch.equal(got, again)
    _close(got, tpconv_g.tpconv_cross_g_plain(*args, irreps_in, irreps_sh, irreps_out, ns))
    assert float(got[-1].abs().max()) == 0.0


@pytest.mark.parametrize("layer,irreps_sh,T,hd", [(1, SH1, 3000, "H"), (3, SH1, 5000, 1), (3, SH1, 333, None),
                                                  (1, SH2, 2000, "H"), (3, SH2, 700, None),
                                                  (3, tpconv_common.TOR_SH_IRREPS, 500, "H")])
def test_edge_bwd_at_l2_node_blocks_matches_plain(dev, layer, irreps_sh, T, hd):
    """Row 10 at the second-order ladder's layers (d_w over output blocks of
    5 components, d_sender over input blocks of 5): against the plain
    version's autograd, bit for bit across launches, masked edges zero."""
    irreps_in, irreps_out = SECOND_LAYERS[layer]
    if irreps_sh == tpconv_common.TOR_SH_IRREPS:
        irreps_out = TOR_OUT
    g = _gen(37)
    F, H = 96, 96
    tp = WeightedTensorProduct(irreps_in, irreps_sh, irreps_out)
    attr, send = torch.randn(T, F, generator=g), torch.randn(T, tp.irreps_in.dim, generator=g)
    sh = torch.randn(T, tpconv_common.sh_dim(irreps_sh), generator=g)
    mask = torch.rand(T, generator=g) >= 0.3
    cot = torch.randn(T, tp.irreps_out.dim, generator=g) * mask[:, None]
    dmask = None if hd is None else (torch.rand(T, H if hd == "H" else 1, generator=g) > 0.1).float() / 0.9
    W = tp.weight_numel
    weights = [(torch.randn(s, generator=g) * 0.2).to(dev) for s in ((F, H), (H,), (H, W), (W,))]
    to = lambda t: None if t is None else t.to(dev).contiguous()
    ins = (to(attr), to(send), to(sh), to(cot), to(dmask), *weights, irreps_in, irreps_sh, irreps_out)
    mask = mask.to(dev)
    got = tpconv_bwd.edge_bwd(*ins, valid=mask)
    again = tpconv_bwd.edge_bwd(*ins, valid=mask)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, (a, b) in enumerate(zip(got, tpconv_bwd.edge_bwd_plain(*ins))):
        _close(a, b, REL if i < 3 else SUM_REL)
    for a in got[:3]:
        assert float(a[~mask].abs().max()) == 0.0


def test_second_order_layers_take_the_general_kernels(dev):
    """A TPConv of the second-order ladder at lmax=1 runs the general route on
    the card: rec_g and cross_g at SHD=4, the edge-list kernel for sums and
    per-edge messages (no ladder kernel), pb and cross_rev declining; each
    within the tolerance of the same layer's CPU plain version."""
    from confidence_bootstrapping_tpu_torch.models.layers import TPConv

    layer = TPConv(SECOND[3], SH1, SECOND[3], 96, hidden_features=96, residual=True)
    assert layer.route == "general"
    g = _gen(39)
    B, N, K, L, ns = 2, 40, 24, 13, 32
    node = torch.randn(B, N, 134, generator=g)
    pos = torch.randn(B, N, 3, generator=g) * 4
    nbr = torch.randint(0, N, (B, N, K), generator=g)
    emb = torch.randn(B, N, K, ns, generator=g)
    sig = torch.randn(B, ns, generator=g)
    mask = torch.rand(B, N, K, generator=g) > 0.3
    lig, lpos = torch.randn(B, L, 134, generator=g), torch.randn(B, L, 3, generator=g)
    idx, cmask = torch.randint(0, N, (B, L, 16), generator=g), torch.rand(B, L, 16, generator=g) > 0.2
    cemb = torch.randn(B, L, 16, ns, generator=g)
    cpu = [layer.conv_rec(0, node, pos, nbr, emb, sig, mask)[0],
           layer.conv_cross(0, lig, lpos, node, pos, idx, cemb, cmask, ns)[0]]
    assert layer.conv_cross_rev(0, 0, lig, lpos, node, pos, idx, cemb, cmask, ns) is None
    layer.to(dev)
    to = lambda *ts: [t.to(dev) for t in ts]
    counters = (tpconv_g.fused_tpconv_rec_g, tpconv_g.fused_tpconv_cross_g, tpconv_edge.fused_tpconv_edge,
                tpconv_rec.fused_tpconv_rec, tpconv_v3.fused_tpconv_nbr)
    before = [c.launches for c in counters]
    got = [layer.conv_rec(0, *to(node, pos, nbr, emb, sig, mask))[0],
           layer.conv_cross(0, *to(lig, lpos, node, pos, idx, cemb, cmask), ns)[0]]
    s_, _ = layer.conv_nbr(0, *to(lig[:, None].expand(B, L, L, 134), torch.randn(B, L, L, 4, generator=g),
                                  torch.randn(B, L, L, 96, generator=g), torch.rand(B, L, L, generator=g) > 0.5))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0]
    for a, b in zip(got, cpu):
        _close(a, b)
