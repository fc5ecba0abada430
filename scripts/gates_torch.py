"""Shared pieces of the port's gate harnesses (``scripts/*_torch.py``).

Each harness ports one of the JAX package's learning or scale gates to the
PyTorch port and writes an artifact under ``docs/artifacts/`` that carries
the JAX artifact's keys plus ``card`` (the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them) and ``device``. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")
for _p in (ROOT, os.path.join(ROOT, "scripts")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def card() -> str:
    """The card's name and power limit from nvidia-smi, or why there is none."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"none ({type(e).__name__})"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "none (nvidia-smi failed)"


def device(arg):
    """The harness's device: ``runtime.resolve_device`` (the card unless
    ``--device cpu``; raises without one)."""
    from confidence_bootstrapping_tpu_torch.runtime import resolve_device

    return resolve_device(arg)


def stamp(art: dict, dev) -> dict:
    """``art`` with the card line, the device and, on the card, its name."""
    import torch

    art["card"] = card()
    art["device"] = str(dev)
    if dev.type == "cuda":
        art["device_name"] = torch.cuda.get_device_name(dev)
    return art


def write(path: str, art: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(art, f, indent=2)
        f.write("\n")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm_tables(dev) -> None:
    """On the card, build (or load) the so3/torus score tables there first,
    so that a CPU lookup afterwards reads the cached files instead of
    building them on the CPU."""
    if dev.type != "cuda":
        return
    from confidence_bootstrapping_tpu_torch.ops import so3, torus

    so3._table(dev), so3._grids(dev), torus._table(dev), torus._score_table(dev)


def load_1a0q(lm_dim: int, all_atoms: bool = False, lm_seed: int = 0):
    """1a0q from the committed featurization cache (``cache/``), with seeded
    ESM-sized receptor features of width ``lm_dim`` and, with ``all_atoms``,
    ``chip_smoke.receptor_atoms``' seeded receptor atoms in the all-atom
    bucket. -> (HostComplex, heavy-atom Molecule)."""
    import chip_smoke
    from confidence_bootstrapping_tpu_torch.data.complex_graph import load_host_cache

    hc, mol = load_host_cache(chip_smoke.CACHE_PKL)
    hc = hc._replace(rec_lm=np.random.RandomState(lm_seed).randn(len(hc.rec_f), lm_dim).astype(np.float32))
    if all_atoms:
        hc = hc._replace(**chip_smoke.receptor_atoms(hc.rec_f, hc.rec_pos, chip_smoke.N_ATOMS))
    return hc, mol


def rmsd_rows(r: np.ndarray) -> dict:
    """min / median / max and the shares under 2 and 5 A of plain RMSDs."""
    return {"min": round(float(r.min()), 3), "median": round(float(np.median(r)), 3),
            "max": round(float(r.max()), 3), "lt2": round(float((r < 2).mean()), 3),
            "lt5": round(float((r < 5).mean()), 3)}
