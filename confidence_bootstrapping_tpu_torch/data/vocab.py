"""Categorical feature vocabularies of the host featurization and the models.

Copy of ``confidence_bootstrapping_tpu/data/vocab.py``: the reference's
``allowable_features`` categories in the same order, so feature indices are
interchangeable between the packages. Out-of-vocabulary values map to the
trailing 'misc' slot (``safe_index``).
"""


ATOMIC_NUMS = list(range(1, 119))  # +misc
CHIRALITY = ["CHI_UNSPECIFIED", "CHI_TETRAHEDRAL_CW", "CHI_TETRAHEDRAL_CCW", "CHI_OTHER"]
DEGREE = list(range(11))  # +misc
NUMRING = list(range(7))  # +misc
IMPLICIT_VALENCE = list(range(7))  # +misc
FORMAL_CHARGE = list(range(-5, 6))  # +misc
NUM_H = list(range(9))  # +misc
NUM_RADICAL_E = list(range(5))  # +misc
HYBRIDIZATION = ["SP", "SP2", "SP3", "SP3D", "SP3D2"]  # +misc

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

# ligand: 16 categorical features, in reference column order
LIG_FEATURE_DIMS = (
    len(ATOMIC_NUMS) + 1,
    len(CHIRALITY),
    len(DEGREE) + 1,
    len(FORMAL_CHARGE) + 1,
    len(IMPLICIT_VALENCE) + 1,
    len(NUM_H) + 1,
    len(NUM_RADICAL_E) + 1,
    len(HYBRIDIZATION) + 1,
    2,  # is_aromatic
    len(NUMRING) + 1,
    2, 2, 2, 2, 2, 2,  # in ring of size 3..8
)

REC_RESIDUE_FEATURE_DIMS = (len(AMINO_ACIDS) + 1,)

REC_ATOM_FEATURE_DIMS = (
    len(AMINO_ACIDS) + 1,
    len(ATOMIC_NUMS) + 1,
    len(ATOM_TYPE_2) + 1,
    len(ATOM_TYPE_3) + 1,
)


def safe_index(lst, value):
    """Index of value in lst, or len(lst) ('misc') if absent."""
    try:
        return lst.index(value)
    except ValueError:
        return len(lst)
