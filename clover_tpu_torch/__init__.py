"""clover_tpu_torch: the PyTorch + CUDA port of clover_tpu for NVIDIA Hopper.

The JAX package ``clover_tpu`` is the frozen reference; this package is
held against it by ``tests/test_torch_*.py``. Port so far: the retrieval
eval forward (Swin video tower + BERT text tower + NCE head) with four
hand-written CUDA kernels under ``csrc/`` (window attention, the two MLP
halves, LayerNorm). It imports torch and never jax; of the JAX package it
reuses only ``clover_tpu.config`` and ``clover_tpu.evaluation.metrics``.
"""

__version__ = "0.1.0"
