"""Runnable examples of the PyTorch/CUDA port (``python -m graphnet_tpu_torch.examples.<name>``)."""
