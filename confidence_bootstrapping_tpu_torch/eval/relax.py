"""Optional pose post-processing hooks: obrms RMSDs and xtb relaxation.

Port of ``confidence_bootstrapping_tpu/eval/relax.py``: host subprocess
wrappers of OpenBabel's ``obrms`` and of the ``xtb`` optimizer behind
``infer --obrms`` and ``infer --xtb``. Where the binary is missing, or fails,
each returns ``None`` and the caller keeps its own numbers.
"""


from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from ..data import mol_io


def have_binary(name: str) -> bool:
    return shutil.which(name) is not None


def obrms(ref_ligand_path: str, mol: mol_io.Molecule, poses: np.ndarray,
          binary: str = "obrms", timeout_s: float = 120.0) -> Optional[np.ndarray]:
    """RMSD of each pose vs the reference ligand file via ``obrms``.

    Returns [n] RMSDs, or None when the binary is unavailable or fails.
    """
    if not have_binary(binary):
        return None
    poses = np.asarray(poses)
    if poses.ndim == 2:
        poses = poses[None]
    with tempfile.TemporaryDirectory() as td:
        pred = os.path.join(td, "poses.sdf")
        with open(pred, "w") as f:
            for i, p in enumerate(poses):
                mol_io.write_sdf(mol, p, os.path.join(td, f"_one{i}.sdf"), name=f"pose{i}")
                f.write(open(os.path.join(td, f"_one{i}.sdf")).read())
        try:
            # obrms <reference> <predictions>: one RMSD line per record of
            # the second file (reference utils/utils.py:38)
            out = subprocess.run(
                [binary, ref_ligand_path, pred],
                capture_output=True, text=True, timeout=timeout_s, check=True,
            ).stdout
        except (subprocess.SubprocessError, OSError):
            return None
    vals: List[float] = []
    for line in out.splitlines():
        m = re.search(r"RMSD.*?([0-9]+\.?[0-9]*)\s*$", line)
        if m:
            vals.append(float(m.group(1)))
    return np.asarray(vals) if len(vals) == len(poses) else None


def xtb_relax(mol: mol_io.Molecule, pose: np.ndarray, binary: str = "xtb",
              gfn: str = "2", timeout_s: float = 600.0) -> Optional[np.ndarray]:
    """Relax one pose with the xtb semi-empirical optimizer.

    Writes an xyz, runs ``xtb --opt``, reads back ``xtbopt.xyz``. Returns
    the relaxed coordinates [n_atoms, 3] or None when unavailable/failed.
    """
    if not have_binary(binary):
        return None
    with tempfile.TemporaryDirectory() as td:
        xyz = os.path.join(td, "pose.xyz")
        with open(xyz, "w") as f:
            f.write(f"{len(pose)}\npose\n")
            for z, p in zip(mol.atomic_nums, np.asarray(pose)):
                sym = mol_io._NUM_TO_SYMBOL.get(int(z), "C")
                f.write(f"{sym} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        try:
            subprocess.run(
                [binary, xyz, "--opt", "--gfn", gfn],
                cwd=td, capture_output=True, timeout=timeout_s, check=True,
            )
            out = os.path.join(td, "xtbopt.xyz")
            lines = open(out).read().splitlines()[2:]
        except (subprocess.SubprocessError, OSError, FileNotFoundError):
            return None
    coords = [[float(x) for x in ln.split()[1:4]] for ln in lines if ln.strip()]
    if len(coords) != len(pose):
        return None
    return np.asarray(coords, dtype=np.float32)
