"""PDBBind dataset layer and the training CLI's dataset selection.

Port of ``confidence_bootstrapping_tpu/data/pdbbind.py`` (the reference's
``datasets/pdbbind.py:136-424`` and ``datasets/loader.py``): a
PDBBind_processed-style tree (``<dir>/<pdbid>/<pdbid>_protein_processed.pdb``
+ ``_ligand.sdf|.mol2``) with name-list splits, ESM per-complex embeddings
and optional conformer matching (``data/dataset.ComplexDataset``);
``CombinedDataset``, which concatenates datasets whose items are
``HostComplex``es or already padded dicts (the bootstrapping dataset's), and
``construct_loader_entries`` for the ``pdbbind``, ``moad``, ``combined`` and
``generalisation`` modes. Batches land on ``device`` (default: the GPU).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .complex_graph import pad_complex, pick_bucket
from .dataset import ComplexDataset, batches_from_padded, discover_dir


def read_strings_from_txt(path: str):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class PDBBindDataset:
    def __init__(
        self,
        data_dir: str,
        split_path: Optional[str] = None,
        cache_path: Optional[str] = "cache",
        lm_embeddings: Optional[Dict[str, np.ndarray]] = None,
        limit_complexes: int = 0,
        multiplicity: int = 1,
        **featurize_kwargs,
    ):
        names = read_strings_from_txt(split_path) if split_path else None
        entries = discover_dir(data_dir, names)
        if limit_complexes:
            entries = entries[:limit_complexes]
        self.multiplicity = multiplicity
        self.dataset = ComplexDataset(entries, cache_dir=cache_path, lm_embeddings=lm_embeddings, **featurize_kwargs)
        self.by_name = {hc.name: hc for hc in self.dataset.complexes}
        self.names = list(self.by_name)

    def __len__(self):
        return len(self.names) * self.multiplicity

    def get(self, idx: int):
        return self.by_name[self.names[idx % len(self.names)]]

    def get_by_name(self, name: str):
        return self.by_name[name]

    def print_statistics(self):
        ligs = [len(hc.lig_f) for hc in self.by_name.values()]
        recs = [len(hc.rec_f) for hc in self.by_name.values()]
        print(
            f"PDBBind: {len(self.by_name)} complexes; ligand atoms "
            f"{np.mean(ligs):.1f}+-{np.std(ligs):.1f}, residues {np.mean(recs):.1f}+-{np.std(recs):.1f}"
        )


class CombinedDataset:
    """Concatenation of datasets (reference datasets/loader.py:15-31
    CombineDatasets): combined_training (MOAD + PDBBind), triple_training
    (+ PDBSidechain), and the bootstrapping dataset mixed into training.
    Empty datasets are dropped. ``device``: where ``epoch_batches`` puts its
    batches (None: the GPU)."""

    def __init__(self, *datasets, device=None):
        self.datasets = [d for d in datasets if d is not None and len(d) > 0]
        self.device = device

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def get(self, idx: int):
        for d in self.datasets:
            if idx < len(d):
                return d.get(idx)
            idx -= len(d)
        raise IndexError

    def lm_dim(self) -> int:
        dims = [0]
        for d in self.datasets:
            if hasattr(d, "lm_dim"):
                dims.append(d.lm_dim())
            elif hasattr(d, "dataset"):
                dims.append(d.dataset.lm_dim())
            elif getattr(d, "items", None):
                dims.append(int(np.asarray(d.items[0][0]["rec_lm"]).shape[-1]))
        return max(dims)

    def epoch_batches(self, batch_size: int, rng: np.random.RandomState, drop_last: bool = False):
        """One pass over every sub-dataset (cluster-random MOAD access,
        confidence-weighted bootstrapping access) -> shuffled padded
        batches. ``HostComplex`` items are padded here, dicts are taken as
        padded; shape signatures keep buckets apart. The same draws from
        ``rng`` as the JAX package's."""
        lm = self.lm_dim()
        padded = []
        for i in rng.permutation(len(self)):
            it = self.get(int(i))
            if isinstance(it, dict):
                padded.append(it)
            else:
                b = pick_bucket(
                    len(it.lig_f), len(it.lig_edge_src), len(it.tor_src), len(it.rec_f),
                    n_atoms=0 if it.atom_f is None else len(it.atom_f),
                    all_atoms=it.atom_f is not None,
                )
                padded.append(pad_complex(it, b, lm_dim=lm))
        return batches_from_padded(padded, batch_size, rng, drop_last=drop_last, device=self.device)


def construct_loader_entries(args_like, **featurize_kwargs) -> CombinedDataset:
    """The dataset selection (reference datasets/loader.py:34-129):
    'pdbbind' | 'moad' | 'combined' | 'generalisation' (triple).

    ``featurize_kwargs`` (all_atoms, the matching options, ``device``, ...)
    go to every featurized sub-dataset so the featurization matches the
    model config; ``device`` is also where the combined batches land."""
    from .moad import MOADDataset

    ds = []
    mode = getattr(args_like, "dataset", "pdbbind")
    limit = getattr(args_like, "limit_complexes", 0) or 0
    if mode in ("pdbbind", "combined", "generalisation"):
        if not getattr(args_like, "pdbbind_dir", None):
            raise ValueError(f"--dataset {mode} requires --pdbbind_dir")
        ds.append(PDBBindDataset(args_like.pdbbind_dir, getattr(args_like, "split_train", None),
                                 cache_path=getattr(args_like, "cache_path", "cache"),
                                 limit_complexes=limit, **featurize_kwargs))
    if mode in ("moad", "combined", "generalisation"):
        if not getattr(args_like, "moad_dir", None):
            raise ValueError(f"--dataset {mode} requires --moad_dir")
        ds.append(MOADDataset(args_like.moad_dir,
                              getattr(args_like, "moad_splits_pkl", None),
                              getattr(args_like, "cluster_to_ligands_pkl", None),
                              cache_path=getattr(args_like, "cache_path", "cache"),
                              limit_complexes=limit, **featurize_kwargs))
    if mode == "generalisation":
        from .pdb_sidechain import PDBSidechainDataset

        pdbdir = getattr(args_like, "pdbsidechain_dir", None)
        if pdbdir and os.path.isdir(pdbdir):
            ds.append(PDBSidechainDataset(pdbdir, cache_path=getattr(args_like, "cache_path", "cache")))
    return CombinedDataset(*ds, device=featurize_kwargs.get("device"))
