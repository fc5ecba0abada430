"""O(3) irreps algebra: spherical harmonics and Clebsch-Gordan tensor products.

Port of ``confidence_bootstrapping_tpu/ops/irreps.py`` for what the score
model reads. Same conventions:

* features are a flat trailing axis of concatenated irrep blocks, each block
  ``mul x (2l+1)`` components in ``Irreps`` order;
* the l=1 basis is plain (x, y, z);
* 'component' normalization: harmonics of degree l have squared norm 2l+1 on
  the unit sphere, each CG path carries sqrt(2 l_out + 1), weighted products
  divide by sqrt(fan_in).

Clebsch-Gordan coefficients are solved on the host in float64 as the null
space of rotation-equivariance constraints, with the same seeds and sign rule
as the JAX package, so both packages use the same tables.
"""

from __future__ import annotations

import functools
import re
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Irreps bookkeeping
# --------------------------------------------------------------------------


class Irrep(NamedTuple):
    l: int
    p: int  # parity: +1 even, -1 odd

    def __str__(self):
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    @property
    def dim(self):
        return 2 * self.l + 1


class MulIrrep(NamedTuple):
    mul: int
    ir: Irrep


class Irreps(tuple):
    """Ordered collection of (mul, Irrep); parses e3nn-style strings."""

    def __new__(cls, spec):
        if isinstance(spec, Irreps):
            return spec
        if isinstance(spec, str):
            items = []
            for part in spec.replace(" ", "").split("+"):
                if not part:
                    continue
                m = re.fullmatch(r"(?:(\d+)x)?(\d+)([eo])", part)
                if not m:
                    raise ValueError(f"bad irrep term {part!r} in {spec!r}")
                mul = int(m.group(1)) if m.group(1) else 1
                items.append(MulIrrep(mul, Irrep(int(m.group(2)), 1 if m.group(3) == "e" else -1)))
            return super().__new__(cls, items)
        return super().__new__(cls, [MulIrrep(int(m), Irrep(int(ir[0]), int(ir[1]))) for m, ir in spec])

    @property
    def dim(self):
        return sum(m * ir.dim for m, ir in self)

    @property
    def num_irreps(self):
        return sum(m for m, _ in self)

    def slices(self):
        out, i = [], 0
        for m, ir in self:
            out.append(slice(i, i + m * ir.dim))
            i += m * ir.dim
        return out

    def __str__(self):
        return " + ".join(f"{m}x{ir}" for m, ir in self)

    def __repr__(self):
        return f"Irreps('{self}')"


def spherical_harmonics_irreps(lmax: int) -> Irreps:
    """0e + 1o + 2e + ... (parity (-1)^l)."""
    return Irreps(" + ".join(f"1x{l}{'e' if l % 2 == 0 else 'o'}" for l in range(lmax + 1)))


# --------------------------------------------------------------------------
# Real spherical harmonics (component normalization, (x, y, z) basis)
# --------------------------------------------------------------------------

# Monomial bases per l, {(ax, ay, az): coeff}: the standard real solid
# harmonics, normalized below so E_{u~S^2}[Y_m(u)^2] = 1. Degrees 3 and 4 are
# needed only to fit the Wigner-D matrices behind the l_out = 3 and 4 CG paths
# (the torsion head's sh (x) 2e product at lmax=1 and lmax=2).
_POLY_BASES = {
    0: [{(0, 0, 0): 1.0}],
    1: [{(1, 0, 0): 1.0}, {(0, 1, 0): 1.0}, {(0, 0, 1): 1.0}],
    2: [
        {(1, 1, 0): 1.0},  # xy
        {(0, 1, 1): 1.0},  # yz
        {(0, 0, 2): 2.0, (2, 0, 0): -1.0, (0, 2, 0): -1.0},  # 2z^2 - x^2 - y^2
        {(1, 0, 1): 1.0},  # zx
        {(2, 0, 0): 1.0, (0, 2, 0): -1.0},  # x^2 - y^2
    ],
    3: [
        {(2, 1, 0): 3.0, (0, 3, 0): -1.0},
        {(1, 1, 1): 1.0},
        {(0, 1, 2): 4.0, (2, 1, 0): -1.0, (0, 3, 0): -1.0},
        {(0, 0, 3): 2.0, (2, 0, 1): -3.0, (0, 2, 1): -3.0},
        {(1, 0, 2): 4.0, (3, 0, 0): -1.0, (1, 2, 0): -1.0},
        {(2, 0, 1): 1.0, (0, 2, 1): -1.0},
        {(3, 0, 0): 1.0, (1, 2, 0): -3.0},
    ],
    4: [
        {(3, 1, 0): 1.0, (1, 3, 0): -1.0},
        {(2, 1, 1): 3.0, (0, 3, 1): -1.0},
        {(1, 1, 2): 6.0, (3, 1, 0): -1.0, (1, 3, 0): -1.0},
        {(0, 1, 3): 4.0, (2, 1, 1): -3.0, (0, 3, 1): -3.0},
        {(4, 0, 0): 3.0, (0, 4, 0): 3.0, (0, 0, 4): 8.0, (2, 2, 0): 6.0, (2, 0, 2): -24.0, (0, 2, 2): -24.0},
        {(1, 0, 3): 4.0, (3, 0, 1): -3.0, (1, 2, 1): -3.0},
        {(2, 0, 2): 6.0, (0, 2, 2): -6.0, (4, 0, 0): -1.0, (0, 4, 0): 1.0},
        {(3, 0, 1): 1.0, (1, 2, 1): -3.0},
        {(4, 0, 0): 1.0, (2, 2, 0): -6.0, (0, 4, 0): 1.0},
    ],
}


def _sphere_monomial_mean(a: int, b: int, c: int) -> float:
    """E[x^a y^b z^c] over the uniform unit sphere (0 unless all even)."""
    if a % 2 or b % 2 or c % 2:
        return 0.0

    def dfact(n):
        r = 1
        while n > 1:
            r *= n
            n -= 2
        return r

    return dfact(a - 1) * dfact(b - 1) * dfact(c - 1) / dfact(a + b + c + 1)


def _poly_inner(p1, p2) -> float:
    tot = 0.0
    for m1, c1 in p1.items():
        for m2, c2 in p2.items():
            tot += c1 * c2 * _sphere_monomial_mean(m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
    return tot


@functools.lru_cache(maxsize=None)
def _sh_norms(l: int) -> Tuple[float, ...]:
    return tuple(1.0 / np.sqrt(_poly_inner(p, p)) for p in _POLY_BASES[l])


def _sh_eval_np(l: int, v: np.ndarray) -> np.ndarray:
    norms = _sh_norms(l)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    cols = []
    for p, n in zip(_POLY_BASES[l], norms):
        acc = np.zeros(v.shape[:-1])
        for (a, b, c), coef in p.items():
            acc = acc + coef * (x**a) * (y**b) * (z**c)
        cols.append(acc * n)
    return np.stack(cols, axis=-1)


def spherical_harmonics(lmax: int, vec: torch.Tensor, normalize: bool = True, eps: float = 1e-12) -> torch.Tensor:
    """Component-normalized real spherical harmonics of ``vec`` [..., 3] for
    l = 0..lmax (lmax <= 2), blocks concatenated on the last axis."""
    if lmax > 2:
        raise NotImplementedError("spherical harmonics are ported up to l=2")
    if normalize:
        vec = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + eps)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    blocks = [torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype, device=vec.device)]
    if lmax >= 1:
        blocks.append(np.sqrt(3.0) * vec)
    if lmax >= 2:
        n = _sh_norms(2)
        blocks.append(
            torch.stack(
                [n[0] * x * y, n[1] * y * z, n[2] * (2 * z * z - x * x - y * y), n[3] * z * x, n[4] * (x * x - y * y)],
                dim=-1,
            )
        )
    return torch.cat(blocks, dim=-1)


# --------------------------------------------------------------------------
# Wigner-D matrices and Clebsch-Gordan coefficients (host numpy)
# --------------------------------------------------------------------------


def _wigner_d_np(l: int, R: np.ndarray) -> np.ndarray:
    """D such that Y_l(R v) = Y_l(v) @ D^T, fitted from polynomial evals."""
    rng = np.random.RandomState(1234 + l)
    v = rng.randn(max(8, 4 * (2 * l + 1)), 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    A = _sh_eval_np(l, v)
    B = _sh_eval_np(l, v @ R.T)
    Dt, *_ = np.linalg.lstsq(A, B, rcond=None)
    return Dt.T


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor K [2l1+1, 2l2+1, 2l3+1], unit Frobenius norm,
    sign fixed so the entry of largest magnitude is positive."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"violates triangle inequality: {l1} x {l2} -> {l3}")
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    n = d1 * d2 * d3
    rng = np.random.RandomState(4321 + 64 * l1 + 8 * l2 + l3)
    rows = []
    for _ in range(4):
        q, r = np.linalg.qr(rng.randn(3, 3))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        D1, D2, D3 = _wigner_d_np(l1, q), _wigner_d_np(l2, q), _wigner_d_np(l3, q)
        rows.append(np.einsum("ia,jb,kc->ijkabc", D1, D2, D3).reshape(n, n) - np.eye(n))
    _, _, vt = np.linalg.svd(np.concatenate(rows, axis=0))
    K = vt[-1].reshape(d1, d2, d3)
    K = K / np.linalg.norm(K)
    flat = K.reshape(-1)
    return K * np.sign(flat[np.argmax(np.abs(flat))])


def _path_cg(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(clebsch_gordan(l1, l2, l3) * np.sqrt(2 * l3 + 1), dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# Tensor products
# --------------------------------------------------------------------------


class PathGroup(NamedTuple):
    """All paths feeding one output irrep block (grouped weight layout)."""

    out_index: int  # index into irreps_out
    paths: Tuple[Tuple[int, int], ...]  # (input irrep index, sh irrep index)
    fan_in: int  # total input multiplicity across paths
    w_shape: Tuple[int, int]  # (fan_in, mul_out)


class WeightedTensorProduct:
    """Fully-connected weighted tensor product x (x) sh -> out.

    Weight layout (the JAX package's): for each output irrep in order, one
    [fan_in, mul_out] row-major matrix; its rows run over the admissible
    (input irrep, sh irrep) paths in input-major order and, within a path,
    over the input multiplicity. Each block is scaled by 1/sqrt(fan_in).
    sh irreps must all have multiplicity 1.
    """

    def __init__(self, irreps_in, irreps_sh, irreps_out):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_sh = Irreps(irreps_sh)
        self.irreps_out = Irreps(irreps_out)
        for mul, _ in self.irreps_sh:
            if mul != 1:
                raise ValueError("sh multiplicities must be 1")
        self.groups: List[PathGroup] = []
        for oi, (mul_out, ir_out) in enumerate(self.irreps_out):
            paths, fan = [], 0
            for ii, (mul_in, ir_in) in enumerate(self.irreps_in):
                for si, (_, ir_sh) in enumerate(self.irreps_sh):
                    if abs(ir_in.l - ir_sh.l) <= ir_out.l <= ir_in.l + ir_sh.l and ir_in.p * ir_sh.p == ir_out.p:
                        paths.append((ii, si))
                        fan += mul_in
            if paths:
                self.groups.append(PathGroup(oi, tuple(paths), fan, (fan, mul_out)))
        self.weight_numel = sum(g.w_shape[0] * g.w_shape[1] for g in self.groups)

    def __call__(self, x: torch.Tensor, sh: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """x [..., dim_in], sh [..., dim_sh], weight [..., weight_numel];
        leading axes broadcast."""
        lead = torch.broadcast_shapes(x.shape[:-1], sh.shape[:-1], weight.shape[:-1])
        in_slices, sh_slices = self.irreps_in.slices(), self.irreps_sh.slices()
        out_blocks = {}
        w_ofs = 0
        for g in self.groups:
            mul_out, ir_out = self.irreps_out[g.out_index]
            contribs = []
            for ii, si in g.paths:
                mul_in, ir_in = self.irreps_in[ii]
                _, ir_sh = self.irreps_sh[si]
                cg = _path_cg(ir_in.l, ir_sh.l, ir_out.l, x)
                # T[..., a, c] = sum_b sh_b cg[a, b, c]; contrib[..., u, c] = sum_a x[..., u, a] T[..., a, c]
                T = torch.einsum("...b,abc->...ac", sh[..., sh_slices[si]], cg)
                blk = x[..., in_slices[ii]].reshape(x.shape[:-1] + (mul_in, ir_in.dim))
                contribs.append(torch.matmul(blk, T))
            stacked = torch.cat(contribs, dim=-2)  # [..., fan_in, 2l_out+1]
            n = g.w_shape[0] * g.w_shape[1]
            w = weight[..., w_ofs : w_ofs + n].reshape(weight.shape[:-1] + g.w_shape) / np.sqrt(g.w_shape[0])
            w_ofs += n
            # out[..., v, c] = sum_u w[..., u, v] stacked[..., u, c]
            out = torch.matmul(w.transpose(-1, -2), stacked)
            out_blocks[g.out_index] = out.reshape(out.shape[:-2] + (mul_out * ir_out.dim,))
        outs = []
        for oi, (mul_out, ir_out) in enumerate(self.irreps_out):
            if oi in out_blocks:
                outs.append(out_blocks[oi].expand(lead + out_blocks[oi].shape[-1:]))
            else:
                outs.append(torch.zeros(lead + (mul_out * ir_out.dim,), dtype=x.dtype, device=x.device))
        return torch.cat(outs, dim=-1)


class FullTensorProduct:
    """Unweighted full tensor product of two irreps vectors.

    Every admissible output irrep once per (in1, in2) pair, in the order
    (i1-major, i2-minor, ascending l3), each path scaled by sqrt(2*l3+1).
    The torsion head's sh (x) Y2(bond axis) product.
    """

    def __init__(self, irreps1, irreps2):
        self.irreps1 = Irreps(irreps1)
        self.irreps2 = Irreps(irreps2)
        paths, out = [], []
        for i1, (m1, ir1) in enumerate(self.irreps1):
            for i2, (m2, ir2) in enumerate(self.irreps2):
                for l3 in range(abs(ir1.l - ir2.l), ir1.l + ir2.l + 1):
                    paths.append((i1, i2, l3))
                    out.append(MulIrrep(m1 * m2, Irrep(l3, ir1.p * ir2.p)))
        self.paths = paths
        self.irreps_out = Irreps([(m, (ir.l, ir.p)) for m, ir in out])

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        s1, s2 = self.irreps1.slices(), self.irreps2.slices()
        outs = []
        for i1, i2, l3 in self.paths:
            m1, ir1 = self.irreps1[i1]
            m2, ir2 = self.irreps2[i2]
            b1 = x1[..., s1[i1]].reshape(x1.shape[:-1] + (m1, ir1.dim))
            b2 = x2[..., s2[i2]].reshape(x2.shape[:-1] + (m2, ir2.dim))
            o = torch.einsum("...ua,...vb,abc->...uvc", b1, b2, _path_cg(ir1.l, ir2.l, l3, x1))
            outs.append(o.reshape(o.shape[:-3] + (m1 * m2 * (2 * l3 + 1),)))
        return torch.cat(outs, dim=-1)


class DepthwiseTensorProduct:
    """'uvu' tensor product: one weight per (path, input channel), no mixing
    across channels (the ``depthwise_convolution`` option; the caller applies
    an equivariant linear map after aggregation).

    Output irreps: one block of mul_in channels per admissible (input, sh,
    l_out) path, sorted by (l, -p) as the JAX package sorts them."""

    def __init__(self, irreps_in, irreps_sh):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_sh = Irreps(irreps_sh)
        paths = []
        for ii, (mul, ir_in) in enumerate(self.irreps_in):
            for si, (_, ir_sh) in enumerate(self.irreps_sh):
                for l3 in range(abs(ir_in.l - ir_sh.l), ir_in.l + ir_sh.l + 1):
                    paths.append((ii, si, Irrep(l3, ir_in.p * ir_sh.p), mul))
        paths.sort(key=lambda t: (t[2].l, -t[2].p))  # stable: input-major within one (l, p)
        self.paths = paths
        self.irreps_out = Irreps([(mul, (ir.l, ir.p)) for _, _, ir, mul in paths])
        self.weight_numel = sum(mul for _, _, _, mul in paths)

    def __call__(self, x: torch.Tensor, sh: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """x [..., dim_in], sh [..., dim_sh], weight [..., weight_numel];
        leading axes broadcast."""
        lead = torch.broadcast_shapes(x.shape[:-1], sh.shape[:-1], weight.shape[:-1])
        in_slices, sh_slices = self.irreps_in.slices(), self.irreps_sh.slices()
        outs = []
        w_ofs = 0
        for ii, si, ir_out, mul in self.paths:
            ir_in, ir_sh = self.irreps_in[ii].ir, self.irreps_sh[si].ir
            blk = x[..., in_slices[ii]].reshape(x.shape[:-1] + (mul, ir_in.dim))
            T = torch.einsum("...b,abc->...ac", sh[..., sh_slices[si]], _path_cg(ir_in.l, ir_sh.l, ir_out.l, x))
            out = torch.matmul(blk, T) * weight[..., w_ofs : w_ofs + mul, None]  # [..., mul, d3]
            w_ofs += mul
            outs.append(out.reshape(out.shape[:-2] + (mul * ir_out.dim,)).expand(lead + (mul * ir_out.dim,)))
        return torch.cat(outs, dim=-1)


def linear_weight_shapes(irreps_in, irreps_out) -> List[Tuple[str, Tuple[int, int]]]:
    """(name, [mul_in, mul_out]) of an equivariant linear map's weight blocks:
    ``w_{ii}_{oi}`` for every input and output block of one irrep type."""
    irreps_in, irreps_out = Irreps(irreps_in), Irreps(irreps_out)
    return [(f"w_{ii}_{oi}", (mi, mo)) for oi, (mo, iro) in enumerate(irreps_out)
            for ii, (mi, iri) in enumerate(irreps_in) if iri == iro]


def linear_apply(irreps_in, irreps_out, x: torch.Tensor, weights: dict, biases: dict | None = None) -> torch.Tensor:
    """Equivariant linear map: multiplicities mixed within each irrep type,
    each output block scaled by 1/sqrt(fan_in); scalar (l=0) outputs take
    the biases ``b_{oi}`` where given. ``weights`` keyed as
    ``linear_weight_shapes`` names them."""
    irreps_in, irreps_out = Irreps(irreps_in), Irreps(irreps_out)
    in_slices = irreps_in.slices()
    outs = []
    for oi, (mo, iro) in enumerate(irreps_out):
        acc, fan = None, 0
        for ii, (mi, iri) in enumerate(irreps_in):
            if iri == iro:
                blk = x[..., in_slices[ii]].reshape(x.shape[:-1] + (mi, iri.dim))
                term = torch.einsum("...ud,uv->...vd", blk, weights[f"w_{ii}_{oi}"])
                acc = term if acc is None else acc + term
                fan += mi
        if acc is None:
            acc = x.new_zeros(x.shape[:-1] + (mo, iro.dim))
        else:
            acc = acc / np.sqrt(fan)
        if biases is not None and iro.l == 0 and f"b_{oi}" in biases:
            acc = acc + biases[f"b_{oi}"][..., None]
        outs.append(acc.reshape(acc.shape[:-2] + (mo * iro.dim,)))
    return torch.cat(outs, dim=-1)
