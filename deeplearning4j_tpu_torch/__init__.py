"""deeplearning4j_tpu_torch: the PyTorch and CUDA port of deeplearning4j_tpu
for NVIDIA Hopper.

The JAX package ``deeplearning4j_tpu`` is the reference; this package
imports nothing of it and nothing of JAX. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``. Kernels written for the
card (``kernels/``) are built at their first launch.
"""
from deeplearning4j_tpu_torch.environment import card_info, default_device

__all__ = ["card_info", "default_device"]
