"""Categorical feature vocabularies the encoders need.

Copy of ``confidence_bootstrapping_tpu/data/vocab.py`` (the reference's
``allowable_features`` order) for the sizes the models read. Each size counts
a trailing 'misc' slot.
"""

# 118 atomic numbers, 4 chiralities, 11 degrees, 11 formal charges,
# 7 implicit valences, 9 H counts, 5 radical counts, 5 hybridizations,
# aromatic, 7 ring counts, in-ring-of-size 3..8
LIG_FEATURE_DIMS = (119, 4, 12, 12, 8, 10, 6, 6, 2, 8, 2, 2, 2, 2, 2, 2)

ATOMIC_NUMS = list(range(1, 119))  # +misc

AMINO_ACIDS = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "HIP", "HIE", "TPO", "HID", "LEV", "MEU", "PTR", "GLV", "CYT", "SEP",
    "HIZ", "CYM", "GLM", "ASQ", "TYS", "CYX", "GLZ",
]  # +misc

ATOM_TYPE_2 = [
    "C*", "CA", "CB", "CD", "CE", "CG", "CH", "CZ", "N*", "ND", "NE", "NH",
    "NZ", "O*", "OD", "OE", "OG", "OH", "OX", "S*", "SD", "SG",
]  # +misc

ATOM_TYPE_3 = [
    "C", "CA", "CB", "CD", "CD1", "CD2", "CE", "CE1", "CE2", "CE3", "CG",
    "CG1", "CG2", "CH2", "CZ", "CZ2", "CZ3", "N", "ND1", "ND2", "NE", "NE1",
    "NE2", "NH1", "NH2", "NZ", "O", "OD1", "OD2", "OE1", "OE2", "OG", "OG1",
    "OH", "OXT", "SD", "SG",
]  # +misc

# residue type (38)
REC_RESIDUE_FEATURE_DIMS = (len(AMINO_ACIDS) + 1,)

# receptor heavy atoms: residue type, element, 2-letter and full atom name
REC_ATOM_FEATURE_DIMS = (len(AMINO_ACIDS) + 1, len(ATOMIC_NUMS) + 1, len(ATOM_TYPE_2) + 1, len(ATOM_TYPE_3) + 1)
