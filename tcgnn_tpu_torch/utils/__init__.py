"""Utilities of the PyTorch port (counterpart of ``tcgnn_tpu.utils``):
parameter and training-state checkpoints (``checkpoint``).  The profiling
helpers are in ``tcgnn_tpu_torch.profiling``."""
