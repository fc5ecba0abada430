"""The CUDA TP-conv kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them. They reach what the main path's fixed buckets do not: ragged
receiver tiles, a K that spans several 64-edge chunks or is not a multiple of
16 (or is 1), wholly masked tiles and batch elements, input and output irreps
that differ (the embedding layers), lmax=2 harmonics (the confidence model's
rec_g and cross_g kernels), and the wrappers' input checks. Tolerance:
max |kernel - plain| <= 2e-4 * max(1, max |plain|), the JAX package's kernel
bar; the plain versions are held against the Pallas kernels by
tests/test_torch_tpconv.py.

Run on the card from the repository root (tests/conftest.py imports JAX,
which the card's machine does not have, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from confidence_bootstrapping_tpu_torch.ops.cuda import tpconv_g, tpconv_lig, tpconv_rec
from confidence_bootstrapping_tpu_torch.ops.irreps import WeightedTensorProduct

pytestmark = pytest.mark.cuda

FLAGSHIP = "32x0e + 6x1o + 6x1e + 6x0o"
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


def _weights(g, irreps_in, irreps_out, ns, dev, sh=SH1):
    W = WeightedTensorProduct(irreps_in, sh, irreps_out).weight_numel
    H = 3 * ns
    shapes = ((3 * ns, H), (H,), (H, W), (W,))
    return [(torch.randn(s, generator=g) * 0.2).to(dev) for s in shapes]


def _close(got, want):
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= REL * scale, (err, scale)


def _ns(irreps):
    return int(irreps.split("x")[0])


@pytest.mark.parametrize("irreps_in,irreps_out,B,N,K,masked", [
    ("32x0e", "32x0e + 6x1o", 1, 37, 24, False),  # the first embedding layer, a ragged last tile
    (FLAGSHIP, FLAGSHIP, 2, 19, 7, True),  # K not a multiple of 16, a wholly masked tile
    ("16x0e + 4x1o + 4x1e", "16x0e + 4x1o + 4x1e + 4x0o", 3, 24, 40, False),  # chunks straddle receivers
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


@pytest.mark.parametrize("irreps_in,irreps_out,B,L,E", [
    ("32x0e", "32x0e + 6x1o", 2, 13, 30),
    (FLAGSHIP, FLAGSHIP, 3, 24, 48),
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
    got = tpconv_lig.fused_tpconv_pb(*args, irreps_in, irreps_out, ns)
    torch.cuda.synchronize()
    _close(got, tpconv_lig.tpconv_pb_plain(*args, irreps_in, irreps_out, ns))


@pytest.mark.parametrize("irreps,B,L,N,K,with_rev", [
    (FLAGSHIP, 2, 13, 19, 5, True),
    (FLAGSHIP, 2, 7, 150, 130, True),  # one receiver's edges span several 64-edge chunks
    ("16x0e + 4x1o + 4x1e + 4x0o", 3, 24, 64, 48, False),
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
    ("24x0e + 6x1o + 6x1e", CONF_TRUNK, 3, 30, 24, True),  # every edge of the last batch element masked
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


@pytest.mark.parametrize("irreps,B,L,N,K", [
    (CONF_TRUNK, 2, 13, 19, 5),
    (CONF_TRUNK, 2, 24, 256, 64),  # the ligand <- receptor group after the crop
    (CONF_TRUNK, 2, 24, 300, 32),  # the ligand <- atom group: two receivers per block
    ("24x0e + 6x1o", 3, 7, 50, 1),  # K = 1
    ("24x0e", 1, 5, 20, 130),  # one receiver's edges span several 64-edge chunks
])
def test_cross_g_kernel_matches_plain(dev, irreps, B, L, N, K):
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
    got = tpconv_g.fused_tpconv_cross_g(*args, irreps, SH2, irreps, ns)
    torch.cuda.synchronize()
    _close(got, tpconv_g.tpconv_cross_g_plain(*args, irreps, SH2, irreps, ns))
    assert float(got[-1].abs().max()) == 0.0 and float(got[0, 0].abs().max()) == 0.0


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
