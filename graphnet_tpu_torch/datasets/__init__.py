"""Datasets of the PyTorch/CUDA port (counterpart of
``graphnet_tpu/datasets``): the synthetic Prometheus database
(``synthetic.py``).  The curated public datasets, which download their
files, are not ported."""
