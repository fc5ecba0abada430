"""Confidence-model training: filtering caches and datasets, the train and
eval steps and the training loop (``dataset.py``, ``train.py``)."""
