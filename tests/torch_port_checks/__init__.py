"""Checks of the PyTorch port (``endoscopy_tpu_torch``) against the JAX package.

Each ``check_*`` function is one case; ``tests/test_torch_port.py`` runs
them all on the CPU.
"""
