"""ESM2 embedding preparation: the FASTA and dedup half, the online run and
the ESMFold gate.

Port of ``confidence_bootstrapping_tpu/data/esm_prep.py``: every chain
sequence to a deduplicated FASTA (``write_dedup_fasta``), the offline ESM
extract's per-sequence ``.pt`` files folded into one dict per complex
(``fold_esm_outputs``), its reader, the two-stage CLI, the online ESM2 run
(``compute_embeddings``) and ``predict_structure`` (ESMFold for
sequence-only docking). Both online functions need the ``esm`` package and
its weights, which the repository does not hold; without the package they
raise the JAX module's ``RuntimeError``.
"""


from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .mol_io import ProteinStructure, parse_pdb


def chain_sequences(structure: ProteinStructure) -> List[Tuple[str, str]]:
    """[(chain id, one-letter sequence)] in chain order of appearance."""
    out = []
    for cname in structure.chains():
        out.append((cname, structure.sequence(cname)))
    return out


def write_dedup_fasta(structures: Dict[str, ProteinStructure], fasta_path: str):
    """Write unique sequences as FASTA; return {(complex, chain): seq_id}.

    Mirrors the reference's ``sequences_to_id`` dedup (it embeds each unique
    sequence once).
    """
    seq_to_id: Dict[str, int] = {}
    mapping: Dict[Tuple[str, str], int] = {}
    for name, st in structures.items():
        for chain, seq in chain_sequences(st):
            if not seq:
                continue
            if seq not in seq_to_id:
                seq_to_id[seq] = len(seq_to_id)
            mapping[(name, chain)] = seq_to_id[seq]
    with open(fasta_path, "w") as f:
        for seq, sid in sorted(seq_to_id.items(), key=lambda kv: kv[1]):
            f.write(f">{sid}\n{seq}\n")
    return mapping


def fold_esm_outputs(extract_dir: str, mapping: Dict[Tuple[str, str], int], out_pt: str, repr_layer: int = 33):
    """ESM extract output dir (one .pt per sequence id) -> one dict keyed by
    complex name with per-chain embeddings concatenated in chain order."""
    import torch

    per_id = {}
    for f in os.listdir(extract_dir):
        if f.endswith(".pt"):
            d = torch.load(os.path.join(extract_dir, f), map_location="cpu", weights_only=False)
            per_id[int(d["label"])] = d["representations"][repr_layer].numpy()

    by_complex: Dict[str, List[np.ndarray]] = {}
    # mapping preserves chain order of appearance (write_dedup_fasta inserts
    # in structure order) — featurization concatenates in that same order,
    # so do NOT sort (chains are often non-alphabetical in biounit files)
    for (name, chain), sid in mapping.items():
        by_complex.setdefault(name, []).append(per_id[sid])
    out = {name: np.concatenate(chunks, axis=0) for name, chunks in by_complex.items()}
    torch.save(out, out_pt)
    return out


def load_embeddings_pt(path: str) -> Dict[str, np.ndarray]:
    import torch

    d = torch.load(path, map_location="cpu", weights_only=False)
    return {k: np.asarray(v) for k, v in d.items()}


def compute_embeddings(structures: Dict[str, ProteinStructure], model_name: str = "esm2_t33_650M_UR50D",
                       device=None):
    """Online ESM2 embeddings {complex: [residues, width]}, every chain's
    last-layer representation in chain order (reference
    utils/inference_utils.py:173-212), the model run on ``device`` (the
    card unless the caller asks for the CPU, ``runtime.resolve_device``).
    Requires the ``esm`` package and its weights; raises ``RuntimeError``
    without the package."""
    try:
        import esm  # type: ignore
        import torch
    except ImportError as e:
        raise RuntimeError(
            "the `esm` package is not installed in this image; use the offline "
            "FASTA -> extract.py -> fold_esm_outputs pipeline instead"
        ) from e
    from ..runtime import resolve_device

    dev = resolve_device(device)
    model, alphabet = esm.pretrained.load_model_and_alphabet(model_name)
    model = model.to(dev).eval()
    bc = alphabet.get_batch_converter()
    out = {}
    for name, st in structures.items():
        chunks = []
        for chain, seq in chain_sequences(st):
            _, _, toks = bc([(chain, seq)])
            with torch.no_grad():
                rep = model(toks.to(dev), repr_layers=[model.num_layers])["representations"][model.num_layers]
            chunks.append(rep[0, 1: len(seq) + 1].cpu().numpy())
        out[name] = np.concatenate(chunks, axis=0)
    return out


def main(argv=None):
    """CLI covering the reference's per-dataset prep scripts
    (``datasets/esm_embedding_preparation.py``, ``*_lm_embedding_preparation*``,
    ``esm_embeddings_to_pt.py``): stage 1 writes the dedup FASTA + mapping
    pickle from a complex directory; stage 2 (--fold) folds an ESM extract
    output dir into the single ``.pt`` consumed at featurization."""
    import argparse
    import pickle

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--data_dir", help="dir of {name}/{name}_protein_processed.pdb complexes")
    p.add_argument("--protein_suffix", default="_protein_processed.pdb")
    p.add_argument("--out_fasta", default="sequences_to_id.fasta")
    p.add_argument("--mapping_out", default="esm_mapping.pkl")
    p.add_argument("--fold", action="store_true", help="stage 2: fold extract outputs to one .pt")
    p.add_argument("--extract_dir", default=None)
    p.add_argument("--mapping", default=None)
    p.add_argument("--out_pt", default="esm_embeddings.pt")
    p.add_argument("--repr_layer", type=int, default=33)
    args = p.parse_args(argv)

    if args.fold:
        with open(args.mapping or args.mapping_out, "rb") as f:
            mapping = pickle.load(f)
        out = fold_esm_outputs(args.extract_dir, mapping, args.out_pt, repr_layer=args.repr_layer)
        print(f"wrote {args.out_pt}: {len(out)} complexes")
        return

    if not args.data_dir:
        raise SystemExit("provide --data_dir (stage 1) or --fold (stage 2)")
    structures = {}
    for n in sorted(os.listdir(args.data_dir)):
        pdb = os.path.join(args.data_dir, n, f"{n}{args.protein_suffix}")
        if os.path.exists(pdb):
            try:
                structures[n] = parse_pdb(pdb)
            except Exception as e:
                print(f"skipping {n}: {type(e).__name__}: {e}")
    mapping = write_dedup_fasta(structures, args.out_fasta)
    with open(args.mapping_out, "wb") as f:
        pickle.dump(mapping, f)
    print(f"wrote {args.out_fasta} ({len(set(mapping.values()))} unique sequences, "
          f"{len(mapping)} chains over {len(structures)} complexes) + {args.mapping_out}")


def predict_structure(sequence: str, out_pdb: str) -> str:
    """ESMFold structure prediction for sequence-only docking inputs
    (reference utils/inference_utils.py:201-212 esm.pretrained.esmfold_v1).
    Requires the ``esm`` package and its weights (network); raises a clear
    error otherwise so callers can ask for a structure file instead."""
    try:
        import esm  # type: ignore
        import torch
    except ImportError as e:
        raise RuntimeError(
            "structure prediction from a protein sequence requires the `esm` "
            "package (ESMFold); install it or provide --protein_path"
        ) from e
    model = esm.pretrained.esmfold_v1().eval()
    with torch.no_grad():
        pdb_str = model.infer_pdb(sequence)
    with open(out_pdb, "w") as f:
        f.write(pdb_str)
    return out_pdb


if __name__ == "__main__":
    main()
