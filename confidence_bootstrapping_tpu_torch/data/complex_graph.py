"""Padded, fixed-shape ligand/receptor complex batches.

Port of ``confidence_bootstrapping_tpu/data/complex_graph.py`` (the score
model's fields and the confidence model's receptor atoms): every complex is
padded to a ``Bucket``, batching is a leading axis, neighbour relations are
fixed-capacity padded lists and dense masks. ``atom_knn`` is the kNN part of
the JAX package's ``data/featurize.featurize_receptor_atoms``. The molecule
and structure classes are ``data.mol_io``'s; a featurization cache the JAX
package pickled reads into them (``load_host_cache``).
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..runtime import resolve_device
from .mol_io import Molecule, ProteinStructure, Residue


class Bucket(NamedTuple):
    """Static pad sizes."""

    L: int  # ligand atoms
    E: int  # directed ligand bond edges
    R: int  # rotatable bonds (torsion slots)
    N: int  # receptor residues
    KR: int = 24  # receptor kNN neighbours
    KC: int = 48  # cross-edge capacity per ligand atom
    A: int = 0  # receptor heavy atoms (0: residue graph only)
    KA: int = 8  # atom kNN neighbours (atom_max_neighbors)
    KCA: int = 24  # ligand-to-atom cross capacity per ligand atom


LIG_SIZES = (16, 24, 32, 48, 64, 96, 128)
REC_SIZES = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072)


def _round_up(x: int, sizes: Sequence[int]) -> int:
    for s in sizes:
        if x <= s:
            return s
    raise ValueError(f"size {x} exceeds largest bucket {sizes[-1]}")


def pick_bucket(n_lig: int, n_bond_edges: int, n_tor: int, n_rec: int, n_atoms: int = 0,
                all_atoms: bool = False) -> Bucket:
    L = _round_up(max(n_lig, 1), LIG_SIZES)
    R = max(8, int(np.ceil(n_tor / 8)) * 8) if n_tor > 0 else 8
    N = _round_up(max(n_rec, 1), REC_SIZES)
    A = _round_up(max(n_atoms, 1), tuple(8 * s for s in REC_SIZES)) if all_atoms else 0
    # 2L directed bond slots, as the JAX package; more where a ring system needs them (the JAX package then raises)
    E = 2 * L if n_bond_edges <= 2 * L else int(np.ceil(n_bond_edges / 8)) * 8
    return Bucket(L=L, E=E, R=R, N=N, KC=min(N, 48), A=A)


@dataclass(frozen=True)
class ComplexBatch:
    """B padded complexes (poses); every tensor has leading dim B."""

    lig_f: torch.Tensor  # int64 [B, L, 16] categorical features
    lig_pos: torch.Tensor  # f32 [B, L, 3]
    lig_mask: torch.Tensor  # bool [B, L]
    lig_edge_src: torch.Tensor  # int64 [B, E] directed bond edges (receiver)
    lig_edge_dst: torch.Tensor  # int64 [B, E] (sender)
    lig_edge_attr: torch.Tensor  # f32 [B, E, 4]
    lig_edge_mask: torch.Tensor  # bool [B, E]
    tor_src: torch.Tensor  # int64 [B, R]
    tor_dst: torch.Tensor  # int64 [B, R]
    tor_mask: torch.Tensor  # bool [B, R]
    mask_rotate: torch.Tensor  # bool [B, R, L]
    rec_f: torch.Tensor  # int64 [B, N]
    rec_lm: torch.Tensor  # f32 [B, N, lm_dim]
    rec_pos: torch.Tensor  # f32 [B, N, 3]
    rec_mask: torch.Tensor  # bool [B, N]
    rec_nbr: torch.Tensor  # int64 [B, N, KR]
    rec_nbr_mask: torch.Tensor  # bool [B, N, KR]
    t_tr: torch.Tensor  # f32 [B]
    t_rot: torch.Tensor  # f32 [B]
    t_tor: torch.Tensor  # f32 [B]
    orig_center: torch.Tensor  # f32 [B, 3]
    # dihedral tuples (c, a, b, d) per torsion slot (SVGD's torsion angles)
    tor_dihedral: Optional[torch.Tensor] = None  # int64 [B, R, 4]
    # receptor heavy atoms (the all-atom confidence model); None when unused
    atom_f: Optional[torch.Tensor] = None  # int64 [B, A, 4] categorical features
    atom_pos: Optional[torch.Tensor] = None  # f32 [B, A, 3]
    atom_mask: Optional[torch.Tensor] = None  # bool [B, A]
    atom_nbr: Optional[torch.Tensor] = None  # int64 [B, A, KA] kNN neighbour indices
    atom_nbr_mask: Optional[torch.Tensor] = None  # bool [B, A, KA]
    atom_res: Optional[torch.Tensor] = None  # int64 [B, A] residue of each atom

    @property
    def batch_size(self) -> int:
        return self.lig_pos.shape[0]

    def replace(self, **changes) -> "ComplexBatch":
        return dataclasses.replace(self, **changes)

    def set_time(self, t_tr, t_rot, t_tor) -> "ComplexBatch":
        """Stamp per-complex diffusion times (floats or [B] tensors)."""
        B, dev = self.batch_size, self.lig_pos.device

        def f(t):
            return torch.as_tensor(t, dtype=torch.float32, device=dev).expand(B).contiguous()

        return self.replace(t_tr=f(t_tr), t_rot=f(t_rot), t_tor=f(t_tor))

    def map(self, fn) -> "ComplexBatch":
        """Apply fn to every tensor field (None fields stay None)."""
        return ComplexBatch(**{f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


class HostComplex(NamedTuple):
    """Host-side (numpy) single complex, unpadded: the JAX package's
    ``HostComplex`` with the same fields and defaults."""

    name: str
    lig_f: np.ndarray
    lig_pos: np.ndarray
    lig_edge_src: np.ndarray
    lig_edge_dst: np.ndarray
    lig_edge_attr: np.ndarray
    tor_src: np.ndarray
    tor_dst: np.ndarray
    mask_rotate: np.ndarray
    rec_f: np.ndarray
    rec_lm: np.ndarray
    rec_pos: np.ndarray
    rec_nbr: np.ndarray
    rec_nbr_mask: np.ndarray
    orig_center: np.ndarray
    orig_lig_pos: np.ndarray
    rec_sidechain: Optional[np.ndarray] = None
    atom_f: Optional[np.ndarray] = None
    atom_pos: Optional[np.ndarray] = None
    atom_nbr: Optional[np.ndarray] = None
    atom_nbr_mask: Optional[np.ndarray] = None
    atom_res: Optional[np.ndarray] = None
    matching_rmsd: float = 0.0
    alt_orig_lig_pos: Optional[np.ndarray] = None


class _CacheUnpickler(pickle.Unpickler):
    _CLASSES = {
        ("confidence_bootstrapping_tpu.data.complex_graph", "HostComplex"): HostComplex,
        ("confidence_bootstrapping_tpu.data.mol_io", "Molecule"): Molecule,
        ("confidence_bootstrapping_tpu.data.mol_io", "Residue"): Residue,
        ("confidence_bootstrapping_tpu.data.mol_io", "ProteinStructure"): ProteinStructure,
    }

    def find_class(self, module, name):
        cls = self._CLASSES.get((module, name))
        if cls is not None:
            return cls
        if module.split(".")[0] == "confidence_bootstrapping_tpu":
            raise pickle.UnpicklingError(f"{module}.{name} has no counterpart in the port")
        return super().find_class(module, name)


def load_host_cache(path: str) -> tuple:
    """Read a featurization cache file (``(HostComplex, Molecule)`` pickled by
    the JAX package) without importing the JAX package -> (complex, molecule
    or None): the molecule's ``atomic_nums`` and ``bonds`` are what the
    symmetry RMSD reads. Only open cache files this repository wrote:
    unpickling runs code."""
    with open(path, "rb") as f:
        obj = _CacheUnpickler(f).load()
    return obj if isinstance(obj, tuple) else (obj, None)


def load_host_complex(path: str) -> HostComplex:
    """The complex of a featurization cache file (``load_host_cache``)."""
    return load_host_cache(path)[0]


def pad_complex(hc: HostComplex, bucket: Bucket, lm_dim: int = 1280) -> dict:
    """Pad a HostComplex to bucket sizes -> dict of numpy arrays (no batch)."""
    l, e, r, n = len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f)
    if l > bucket.L or e > bucket.E or r > bucket.R or n > bucket.N:
        raise ValueError(f"complex {hc.name} ({l},{e},{r},{n}) exceeds bucket {bucket}")
    L, E, R, N, KR = bucket.L, bucket.E, bucket.R, bucket.N, bucket.KR

    def pad(a, shape, dtype=None):
        out = np.zeros(shape, dtype=dtype or a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    rec_lm = hc.rec_lm if hc.rec_lm.shape[-1] == lm_dim else np.zeros((n, lm_dim), dtype=np.float32)
    kr = min(hc.rec_nbr.shape[1], KR) if hc.rec_nbr.size else 0
    out = dict(
        lig_f=pad(hc.lig_f.astype(np.int64), (L, hc.lig_f.shape[1])),
        lig_pos=pad(hc.lig_pos.astype(np.float32), (L, 3)),
        lig_mask=pad(np.ones(l, dtype=bool), (L,)),
        lig_edge_src=pad(hc.lig_edge_src.astype(np.int64), (E,)),
        lig_edge_dst=pad(hc.lig_edge_dst.astype(np.int64), (E,)),
        lig_edge_attr=pad(hc.lig_edge_attr.astype(np.float32), (E, 4)),
        lig_edge_mask=pad(np.ones(e, dtype=bool), (E,)),
        tor_src=pad(hc.tor_src.astype(np.int64), (R,)),
        tor_dst=pad(hc.tor_dst.astype(np.int64), (R,)),
        tor_mask=pad(np.ones(r, dtype=bool), (R,)),
        mask_rotate=pad(hc.mask_rotate.astype(bool), (R, L)),
        rec_f=pad(hc.rec_f.astype(np.int64), (N,)),
        rec_lm=pad(rec_lm.astype(np.float32), (N, lm_dim)),
        rec_pos=pad(hc.rec_pos.astype(np.float32), (N, 3)),
        rec_mask=pad(np.ones(n, dtype=bool), (N,)),
        rec_nbr=pad(hc.rec_nbr[:, :kr].astype(np.int64), (N, KR)),
        rec_nbr_mask=pad(hc.rec_nbr_mask[:, :kr].astype(bool), (N, KR)),
        t_tr=np.zeros((), np.float32),
        t_rot=np.zeros((), np.float32),
        t_tor=np.zeros((), np.float32),
        orig_center=hc.orig_center.astype(np.float32),
        tor_dihedral=tor_dihedral(hc, R),
    )
    if bucket.A and hc.atom_f is not None:
        a, A, KA = len(hc.atom_f), bucket.A, bucket.KA
        if a > A:
            raise ValueError(f"complex {hc.name} has {a} atoms, over the bucket's {A}")
        ka = min(hc.atom_nbr.shape[1], KA) if hc.atom_nbr is not None and hc.atom_nbr.size else 0
        out.update(
            atom_f=pad(hc.atom_f.astype(np.int64), (A, hc.atom_f.shape[1])),
            atom_pos=pad(hc.atom_pos.astype(np.float32), (A, 3)),
            atom_mask=pad(np.ones(a, dtype=bool), (A,)),
            atom_nbr=pad(hc.atom_nbr[:, :ka].astype(np.int64), (A, KA)) if ka else np.zeros((A, KA), np.int64),
            atom_nbr_mask=pad(hc.atom_nbr_mask[:, :ka].astype(bool), (A, KA)) if ka else np.zeros((A, KA), bool),
            atom_res=pad(hc.atom_res.astype(np.int64), (A,)),
        )
    return out


def tor_dihedral(hc: HostComplex, R: int) -> np.ndarray:
    """[R, 4] int64 dihedral tuples (c, a, b, d) of the rotatable bonds, as
    the JAX package's ``pad_complex`` builds them: c is the first bond
    neighbour of a that is not b, d the first of b that is not a (the bond's
    own atom where there is none); zero rows for the padded slots."""
    dih = np.zeros((R, 4), dtype=np.int64)
    adj: dict = {}
    for s_, d_ in zip(hc.lig_edge_src, hc.lig_edge_dst):
        adj.setdefault(int(s_), []).append(int(d_))
    for k in range(len(hc.tor_src)):
        a, b = int(hc.tor_src[k]), int(hc.tor_dst[k])
        c = next((x for x in adj.get(a, []) if x != b), a)
        d = next((x for x in adj.get(b, []) if x != a), b)
        dih[k] = [c, a, b, d]
    return dih


def atom_knn(atom_pos: np.ndarray, atom_radius: float = 5.0, atom_max_neighbors: int = 8):
    """Receptor-atom kNN lists as the JAX package's featurization builds them:
    each atom's ``atom_max_neighbors`` nearest other atoms (scipy cKDTree),
    masked where farther than ``atom_radius``. -> (nbr [a, K] int64, mask
    [a, K] bool)."""
    a = len(atom_pos)
    k = min(atom_max_neighbors, a - 1)
    d, idx = cKDTree(atom_pos).query(atom_pos, k=k + 1)
    return idx[:, 1:].astype(np.int64), d[:, 1:] < atom_radius


def batch_complexes(padded: Sequence[dict], device=None) -> ComplexBatch:
    """Stack padded complex dicts (same bucket) into a ComplexBatch on
    ``device`` (default: the GPU)."""
    device = resolve_device(device)
    stacked = {k: torch.as_tensor(np.stack([p[k] for p in padded]), device=device) for k in padded[0]}
    return ComplexBatch(**stacked)


def replicate_complex(p: dict, n: int, device=None) -> ComplexBatch:
    """Batch n copies of one padded complex (n poses of the same complex)."""
    return batch_complexes([p] * n, device)
