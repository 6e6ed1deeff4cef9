"""clover_tpu_torch: the PyTorch + CUDA port of clover_tpu for NVIDIA Hopper.

The JAX package ``clover_tpu`` is the frozen reference; this package is
held against it by ``tests/test_torch_*.py``. It has the models, losses,
train and eval steps and loops, the data pipeline, checkpoints, the
trainer and the train / test entry points (``clover_tpu_torch.tools``),
with hand-written CUDA kernels under ``csrc/`` for every Pallas kernel of
the JAX package. It imports torch and never jax, and nothing of
``clover_tpu``: it keeps its own copies of the host code it needs.
"""

__version__ = "0.1.0"
