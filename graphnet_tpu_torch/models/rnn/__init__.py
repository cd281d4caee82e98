"""rnn of the PyTorch/CUDA port (see graphnet_tpu_torch/__init__.py)."""
