"""endoscopy_tpu_torch — the PyTorch/CUDA port of ``endoscopy_tpu``.

A second package beside the JAX one, for NVIDIA Hopper cards. Module names
mirror the JAX package so each port module's counterpart is easy to find;
the JAX package stays the reference the port's tests hold it against.

The port imports ``torch`` and never ``jax`` or anything of
``endoscopy_tpu``: host helpers it needs are copied here. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"`` (see ``device.py``).
The one hand-written kernel so far, RandAugmentMC + CutoutAbs, is CUDA C++
under ``ops/csrc/``, built with ``torch.utils.cpp_extension.load`` at
first use.
"""

__version__ = "0.1.0"
