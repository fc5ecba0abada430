"""Binding MOAD / DockGen dataset layer.

Port of ``confidence_bootstrapping_tpu/data/moad.py``: the ECOD-cluster split
and cluster-to-ligands pickles (``load_cluster_splits``,
``load_cluster_to_ligands``, which ``cli/infer --moad_splits_pkl`` reads), and
``MOADDataset`` over ``dataset.ComplexDataset``: the size, promiscuity,
PDBBind-overlap and timesplit filters, ``unroll_clusters``, cluster-random
``get`` and ``get_by_name``. Files are laid out as
``<dir>/<name>/<name>_protein_processed.pdb`` + ``_ligand.sdf``.
"""


from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .dataset import ComplexDataset, discover_dir


def load_cluster_splits(splits_pkl: str, split: str) -> List[str]:
    """Split name -> list of cluster names. 'train' maps to the 'PDBBind'
    entry like the reference (moad.py:83-87)."""
    if split == "train":
        split = "PDBBind"
    with open(splits_pkl, "rb") as f:
        return pickle.load(f)[split]


def load_cluster_to_ligands(path: str) -> Dict[str, List[str]]:
    with open(path, "rb") as f:
        return pickle.load(f)


class MOADDataset:
    def __init__(
        self,
        data_dir: str,
        splits_pkl: Optional[str] = None,
        cluster_to_ligands_pkl: Optional[str] = None,
        split: str = "train",
        cache_path: Optional[str] = "cache",
        single_cluster_name: Optional[str] = None,
        min_ligand_size: int = 0,
        max_receptor_size: Optional[int] = None,
        remove_promiscuous_targets: Optional[int] = None,
        unroll_clusters: bool = False,
        remove_pdbbind: bool = False,
        enforce_timesplit: bool = False,
        pdbbind_names: Sequence[str] = (),
        timesplit_names: Sequence[str] = (),
        limit_complexes: int = 0,
        total_dataset_size: Optional[int] = None,
        multiplicity: int = 1,
        seed: int = 0,
        **featurize_kwargs,
    ):
        self.rng = np.random.RandomState(seed)
        self.multiplicity = multiplicity

        if splits_pkl and cluster_to_ligands_pkl:
            self.split_clusters = load_cluster_splits(splits_pkl, split)
            self.cluster_to_ligands = load_cluster_to_ligands(cluster_to_ligands_pkl)
        else:
            # degenerate mode: every complex in data_dir is its own cluster
            names = [e[0] for e in discover_dir(data_dir)]
            self.split_clusters = names
            self.cluster_to_ligands = {n: [n] for n in names}

        if single_cluster_name is not None:
            self.split_clusters = [single_cluster_name]

        if remove_pdbbind and pdbbind_names:
            drop = {n[:6] for n in pdbbind_names}
            self.cluster_to_ligands = {
                k: [l for l in v if l[:6] not in drop] for k, v in self.cluster_to_ligands.items()
            }
        if enforce_timesplit and timesplit_names:
            keep = set(timesplit_names)
            self.cluster_to_ligands = {k: [l for l in v if l in keep] for k, v in self.cluster_to_ligands.items()}

        wanted = [n for c in self.split_clusters for n in self.cluster_to_ligands.get(c, [])]
        if limit_complexes:
            wanted = wanted[:limit_complexes]

        entries = discover_dir(data_dir, [n for n in wanted if os.path.isdir(os.path.join(data_dir, n))])
        found = {e[0] for e in entries}
        missing = [n for n in wanted if n not in found]
        if missing:
            print(f"MOAD: {len(missing)} of {len(wanted)} cluster ligands not found on disk")

        self.dataset = ComplexDataset(
            entries,
            cache_dir=cache_path,
            min_ligand_size=min_ligand_size,
            max_receptor_size=max_receptor_size,
            **featurize_kwargs,
        )
        self.by_name = {hc.name: hc for hc in self.dataset.complexes}

        if remove_promiscuous_targets is not None:
            by_rec: Dict[str, int] = {}
            for n in self.by_name:
                by_rec[n[:6]] = by_rec.get(n[:6], 0) + 1
            keep = {n for n in self.by_name if by_rec[n[:6]] <= remove_promiscuous_targets}
            self._filter(keep)

        if unroll_clusters:
            recs = sorted({n[:6] for n in self.by_name})
            self.cluster_to_ligands = {r: [n for n in self.by_name if n[:6] == r] for r in recs}
            self.split_clusters = recs
        else:
            self.cluster_to_ligands = {
                c: [n for n in self.cluster_to_ligands.get(c, []) if n in self.by_name] for c in self.split_clusters
            }
            self.split_clusters = [c for c in self.split_clusters if self.cluster_to_ligands[c]]

        if total_dataset_size is not None and len(self.split_clusters) > total_dataset_size:
            idx = self.rng.choice(len(self.split_clusters), total_dataset_size, replace=False)
            self.split_clusters = [self.split_clusters[i] for i in idx]

    def _filter(self, keep):
        self.by_name = {n: hc for n, hc in self.by_name.items() if n in keep}
        self.dataset.complexes = [hc for hc in self.dataset.complexes if hc.name in keep]

    def __len__(self):
        return len(self.split_clusters) * self.multiplicity

    def get(self, idx: int):
        """Cluster-random access: complex idx -> random ligand of the cluster
        (reference moad.py:271-288 picks randomly within the cluster)."""
        cluster = self.split_clusters[idx % len(self.split_clusters)]
        name = self.cluster_to_ligands[cluster][self.rng.randint(len(self.cluster_to_ligands[cluster]))]
        return self.by_name[name]

    def get_by_name(self, name: str):
        return self.by_name[name]

    def get_all_complexes(self) -> Dict[str, object]:
        return dict(self.by_name)

    def print_statistics(self):
        ligs = [len(hc.lig_f) for hc in self.by_name.values()]
        recs = [len(hc.rec_f) for hc in self.by_name.values()]
        print(
            f"MOAD: {len(self.by_name)} complexes in {len(self.split_clusters)} clusters; "
            f"ligand atoms {np.mean(ligs):.1f}+-{np.std(ligs):.1f}, residues {np.mean(recs):.1f}+-{np.std(recs):.1f}"
        )
