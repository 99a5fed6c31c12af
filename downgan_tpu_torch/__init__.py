"""PyTorch/CUDA port of downgan_tpu for NVIDIA Hopper (H100).

The JAX package ``downgan_tpu`` is the reference this package is held
against; nothing here imports it. The first slice serves the RRDB
generator: ``serving.py`` over ``models/generator.py``, whose
DenseResidualBlocks run through the hand-written CUDA kernel in
``ops/cuda/drb.cu``.
"""
from downgan_tpu_torch.config.config import REGIONS, Config, HyperParams

__all__ = ["Config", "HyperParams", "REGIONS"]
