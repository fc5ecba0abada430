"""Optional gnina rescoring hook (reference ``utils/gnina_utils.py``).

Port of ``confidence_bootstrapping_tpu/eval/gnina.py``: shells out to a
user-provided ``gnina`` binary to rescore or locally refine sampled poses
and parses the CNNscore back from its output SDF. Without the binary
``gnina_rescore`` returns None.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from ..data import mol_io


def have_gnina(binary: str = "gnina") -> bool:
    return shutil.which(binary) is not None


def parse_cnn_scores_from_sdf(path: str) -> List[float]:
    """CNNscore property values of each molecule record in an SDF."""
    scores, grab = [], False
    with open(path) as f:
        for line in f:
            if grab:
                try:
                    scores.append(float(line.strip()))
                except ValueError:
                    pass
                grab = False
            if line.startswith("> <CNNscore>") or line.startswith(">  <CNNscore>"):
                grab = True
    return scores


def gnina_rescore(mol: mol_io.Molecule, poses: np.ndarray, protein_path: str, binary: str = "gnina",
                  minimize: bool = False, timeout_s: float = 600.0) -> Optional[np.ndarray]:
    """CNNscores [n] of the poses [n, atoms, 3] by gnina (``--score_only``, or
    ``--local_only`` with ``minimize``); None without the binary or when its
    output holds no score."""
    if not have_gnina(binary):
        return None
    with tempfile.TemporaryDirectory() as tmp:
        in_sdf, out_sdf = os.path.join(tmp, "poses.sdf"), os.path.join(tmp, "scored.sdf")
        text = []
        for i, p in enumerate(poses):
            single = os.path.join(tmp, f"p{i}.sdf")
            mol_io.write_sdf(mol, p, single, name=f"pose{i}")
            with open(single) as f:
                text.append(f.read())
        with open(in_sdf, "w") as f:
            f.write("".join(text))
        cmd = [binary, "--receptor", protein_path, "--ligand", in_sdf, "--out", out_sdf,
               "--local_only" if minimize else "--score_only"]
        subprocess.run(cmd, check=True, timeout=timeout_s, capture_output=True)
        scores = parse_cnn_scores_from_sdf(out_sdf)
    return np.asarray(scores) if scores else None
