"""Featurized-complex dataset with an idempotent on-disk cache.

Port of ``confidence_bootstrapping_tpu/data/dataset.py``: featurize each
complex once, pickle ``(HostComplex, Molecule)`` into a cache directory under
the same key as the JAX package (``_cache_key``), so that either package
finds the other's files, and serve padded batches grouped by bucket. Cache
files are read through ``complex_graph._CacheUnpickler``, which maps the JAX
package's classes onto the port's. ``num_workers > 1`` fills the cache from
a spawn pool; the parent then reads it serially, so the result is the same
as a serial build. Batches land on ``device`` (default: the GPU).
"""


from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import featurize, mol_io
from .complex_graph import HostComplex, _CacheUnpickler, batch_complexes, pad_complex, pick_bucket


def _featurize_entry_to_cache(task):
    """Pool worker: featurize one complex and atomically write its cache
    file (reference runs multiprocessing pools writing pickle chunks,
    datasets/moad.py:297-340). Idempotent: an existing file is left alone,
    concurrent writers race benignly via os.replace. Returns (name, ok)."""
    name, prot, lig, cache_path, params, lm_emb = task
    if os.path.exists(cache_path):
        return name, True
    try:
        mol = mol_io.read_molecule(lig)
        structure = mol_io.parse_pdb(prot)
        hc = featurize.build_host_complex(name, mol, structure, lm_embeddings=lm_emb, **params)
        heavy = mol.remove_hs() if params.get("remove_hs", True) else mol
        alts = discover_alt_poses(lig, heavy.num_atoms)
        if alts:
            hc = hc._replace(alt_orig_lig_pos=np.stack(alts) - hc.orig_center[None, None])
        tmp = f"{cache_path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump((hc, heavy), f)
        os.replace(tmp, cache_path)
        return name, True
    except Exception as e:
        print(f"skipping {name}: {type(e).__name__}: {e}")
        return name, False


class ComplexDataset:
    """A list of featurized complexes with bucket-grouped batch serving."""

    def __init__(
        self,
        entries: Sequence[Tuple[str, str, str]],  # (name, protein_path, ligand_path)
        cache_dir: Optional[str] = None,
        lm_embeddings: Optional[Dict[str, np.ndarray]] = None,
        remove_hs: bool = True,
        c_alpha_max_neighbors: int = 24,
        receptor_radius: float = 15.0,
        knn_only_graph: bool = True,
        all_atoms: bool = False,
        atom_radius: float = 5.0,
        atom_max_neighbors: int = 8,
        max_lig_size: Optional[int] = None,
        min_ligand_size: int = 0,
        max_receptor_size: Optional[int] = None,
        num_workers: int = 1,
        matching: bool = False,
        matching_tries: int = 3,
        matching_popsize: int = 15,
        matching_maxiter: int = 20,
        device=None,
    ):
        self.params = dict(
            remove_hs=remove_hs,
            c_alpha_max_neighbors=c_alpha_max_neighbors,
            receptor_radius=receptor_radius,
            knn_only_graph=knn_only_graph,
            all_atoms=all_atoms,
            atom_radius=atom_radius,
            atom_max_neighbors=atom_max_neighbors,
        )
        # training-time conformer matching (reference pdbbind.py matching
        # flag -> process_mols.py:609-666): the served pose carries
        # ETKDG-style local geometry matched+aligned to the crystal
        if matching:
            self.params.update(
                conformer_mode="match",
                matching_tries=matching_tries,
                matching_popsize=matching_popsize,
                matching_maxiter=matching_maxiter,
            )
        self.cache_dir = cache_dir
        self.device = device  # where epoch_batches puts its batches (None: the GPU)
        self.lm_embeddings = lm_embeddings or {}
        self.complexes: List[HostComplex] = []
        self.mols: Dict[str, mol_io.Molecule] = {}

        if num_workers > 1 and cache_dir and len(entries) > 1:
            # parallel host preprocessing (reference multiprocessing pools,
            # datasets/moad.py:297-340): workers fill the idempotent
            # per-complex cache, the parent then loads serially below —
            # byte-identical to a serial build (same code path writes)
            import multiprocessing as mp

            os.makedirs(cache_dir, exist_ok=True)
            tasks = [
                (name, prot, lig, os.path.join(cache_dir, self._cache_key(name, prot, lig)),
                 self.params, self.lm_embeddings.get(name))
                for name, prot, lig in entries
                if not os.path.exists(os.path.join(cache_dir, self._cache_key(name, prot, lig)))
            ]
            if tasks:
                ctx = mp.get_context("spawn")  # never fork a process that may hold a CUDA context
                with ctx.Pool(num_workers) as pool:
                    chunk = max(1, min(1000, len(tasks) // num_workers))  # reference: 1000-complex chunks
                    for _name, _ok in pool.imap_unordered(_featurize_entry_to_cache, tasks, chunksize=chunk):
                        pass

        for name, prot, lig in entries:
            try:
                hc, heavy = self._featurize_one(name, prot, lig)
            except Exception as e:
                print(f"skipping {name}: {type(e).__name__}: {e}")
                continue
            n_lig, n_rec = len(hc.lig_f), len(hc.rec_f)
            if n_lig < min_ligand_size or (max_lig_size and n_lig > max_lig_size):
                continue
            if max_receptor_size and n_rec > max_receptor_size:
                continue
            self.complexes.append(hc)
            self.mols[name] = heavy

    def _cache_key(self, name: str, prot: str, lig: str) -> str:
        h = hashlib.sha1(repr((name, prot, lig, sorted(self.params.items()))).encode()).hexdigest()[:16]
        return f"{name}_{h}.pkl"

    def _featurize_one(self, name, prot, lig):
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            path = os.path.join(self.cache_dir, self._cache_key(name, prot, lig))
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return _CacheUnpickler(f).load()
        mol = mol_io.read_molecule(lig)
        structure = mol_io.parse_pdb(prot)
        hc = featurize.build_host_complex(name, mol, structure, lm_embeddings=self.lm_embeddings.get(name), **self.params)
        heavy = mol.remove_hs() if self.params["remove_hs"] else mol
        alts = discover_alt_poses(lig, heavy.num_atoms)
        if alts:
            hc = hc._replace(alt_orig_lig_pos=np.stack(alts) - hc.orig_center[None, None])
        if self.cache_dir:  # written aside, then renamed: a rank featurizing the same complex never reads half a file
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump((hc, heavy), f)
            os.replace(tmp, path)
        return hc, heavy

    def __len__(self):
        return len(self.complexes)

    def print_statistics(self):
        """Dataset sanity statistics at load (reference pdbbind.py:427-461):
        ligand/receptor sizes, radii, torsion counts, matching RMSD."""
        if not self.complexes:
            print("dataset is empty")
            return
        lig_sizes = np.array([len(hc.lig_f) for hc in self.complexes])
        rec_sizes = np.array([len(hc.rec_f) for hc in self.complexes])
        tors = np.array([len(hc.tor_src) for hc in self.complexes])
        lig_rad = np.array([np.linalg.norm(hc.lig_pos - hc.lig_pos.mean(0), axis=1).max() for hc in self.complexes])
        rec_rad = np.array([np.linalg.norm(hc.rec_pos, axis=1).max() for hc in self.complexes])
        match = np.array([hc.matching_rmsd for hc in self.complexes])
        print(f"dataset: {len(self.complexes)} complexes")
        print(f"  ligand atoms  mean {lig_sizes.mean():.1f}  max {lig_sizes.max()}")
        print(f"  rotatable bonds mean {tors.mean():.1f}  max {tors.max()}")
        print(f"  receptor residues mean {rec_sizes.mean():.1f}  max {rec_sizes.max()}")
        print(f"  ligand radius mean {lig_rad.mean():.2f}  receptor radius mean {rec_rad.mean():.2f}")
        if match.any():
            print(f"  conformer matching rmsd mean {match.mean():.3f}  max {match.max():.3f}")

    def lm_dim(self):
        dims = {hc.rec_lm.shape[-1] for hc in self.complexes}
        return max(dims) if dims else 0

    def padded_by_bucket(self) -> Dict[tuple, List[dict]]:
        """Pad all complexes, grouped by their bucket."""
        groups: Dict[tuple, List[dict]] = {}
        lm = self.lm_dim()
        for hc in self.complexes:
            b = pick_bucket(
                len(hc.lig_f), len(hc.lig_edge_src), len(hc.tor_src), len(hc.rec_f),
                n_atoms=0 if hc.atom_f is None else len(hc.atom_f),
                all_atoms=self.params["all_atoms"],
            )
            groups.setdefault(tuple(b), []).append(pad_complex(hc, b, lm_dim=lm))
        return groups

    def get(self, idx: int) -> HostComplex:
        return self.complexes[idx]

    def epoch_batches(self, batch_size: int, rng: np.random.RandomState, drop_last: bool = False):
        """Shuffled padded batches on the dataset's device, one bucket per batch."""
        groups = self.padded_by_bucket()
        padded = [p for items in groups.values() for p in items]
        return batches_from_padded(padded, batch_size, rng, drop_last=drop_last, device=self.device)


def padded_signature(p: dict) -> tuple:
    """Hashable shape signature of a padded complex dict: items batch
    together iff every array shape matches (same bucket, same lm dim,
    same optional keys)."""
    return tuple(sorted((k, np.asarray(v).shape) for k, v in p.items()))


def batches_from_padded(padded, batch_size: int, rng: np.random.RandomState, drop_last: bool = False, device=None):
    """Group padded complex dicts by shape signature and stack shuffled
    fixed-size batches on ``device`` (default: the GPU); short tails are
    repeated to keep the batch size, as in the JAX package."""
    groups: Dict[tuple, List[dict]] = {}
    for p in padded:
        groups.setdefault(padded_signature(p), []).append(p)
    batches = []
    for items in groups.values():
        idx = rng.permutation(len(items))
        for s in range(0, len(items), batch_size):
            sel = idx[s : s + batch_size]
            if drop_last and len(sel) < batch_size:
                continue
            chosen = [items[i] for i in sel]
            while len(chosen) < batch_size:
                chosen.append(chosen[len(chosen) % len(sel)])
            batches.append(batch_complexes(chosen, device))
    rng.shuffle(batches)
    return batches


def discover_alt_poses(lig_path: str, n_heavy: int) -> List[np.ndarray]:
    """Alternative ground-truth binding poses next to the primary ligand.

    Convention mirroring the reference's multi-pose lookup
    (datasets/moad.py:506-518 scans sibling ``{base}_{i}.pdb`` files): any
    ``{stem}_{i}{ext}`` sibling of ``{stem}{ext}`` whose heavy-atom count
    matches the primary ligand contributes its coordinates as an extra
    valid pose. Evaluation takes the min-RMSD over all of them.

    Additionally, when the stem itself ends in ``_{int}`` (the MOAD
    superligand naming ``{pdbid}_{chain}_{lig}_{copy}``), sibling copies
    ``{base}_{i}{ext}`` with i != own copy index are collected the same way
    (reference datasets/moad.py:506-518 scans exactly this pattern).
    """
    stem, ext = os.path.splitext(lig_path)
    candidates: List[str] = []
    for i in range(100):
        p = f"{stem}_{i}{ext}"
        if not os.path.exists(p):
            break
        candidates.append(p)
    parts = stem.rsplit("_", 1)
    if len(parts) == 2 and parts[1].isdigit():
        base, own = parts[0], int(parts[1])
        for i in range(100):
            if i == own:
                continue
            p = f"{base}_{i}{ext}"
            if not os.path.exists(p):
                if i > own:
                    break
                continue
            candidates.append(p)
    out = []
    for p in candidates:
        try:
            m = mol_io.read_molecule(p).remove_hs()
        except Exception:
            continue
        if m.num_atoms == n_heavy:
            out.append(np.asarray(m.pos, dtype=np.float32))
    return out


def discover_dir(data_dir: str, names: Optional[Sequence[str]] = None, protein_suffix="_protein_processed.pdb"):
    """PDBBind/DockGen-style directory layout -> entries list."""
    out = []
    listing = sorted(os.listdir(data_dir)) if names is None else list(names)
    for n in listing:
        d = os.path.join(data_dir, n)
        if not os.path.isdir(d):
            continue
        prot = os.path.join(d, f"{n}{protein_suffix}")
        for ext in (".sdf", ".mol2", ".mol"):
            lig = os.path.join(d, f"{n}_ligand{ext}")
            if os.path.exists(lig):
                break
        else:
            continue
        if os.path.exists(prot):
            out.append((n, prot, lig))
    return out
