"""Categorical feature vocabulary sizes the encoders need.

Copy of the sizes in ``confidence_bootstrapping_tpu/data/vocab.py`` (the
reference's ``allowable_features`` order). Each size counts a trailing 'misc'
slot.
"""

# 118 atomic numbers, 4 chiralities, 11 degrees, 11 formal charges,
# 7 implicit valences, 9 H counts, 5 radical counts, 5 hybridizations,
# aromatic, 7 ring counts, in-ring-of-size 3..8
LIG_FEATURE_DIMS = (119, 4, 12, 12, 8, 10, 6, 6, 2, 8, 2, 2, 2, 2, 2, 2)

# 37 residue types + misc
REC_RESIDUE_FEATURE_DIMS = (38,)
