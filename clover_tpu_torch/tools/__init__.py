"""Entry points of the port: ``python -m clover_tpu_torch.tools.train`` and ``.test``."""
