"""PyTorch/CUDA port of modest_tpu for NVIDIA Hopper (H100).

The JAX package ``modest_tpu`` stays the reference; this package mirrors its
file layout (``modest_tpu/<path>.py`` ↔ ``modest_tpu_torch/<path>.py``) and
imports only torch, numpy and the standard library. Every Pallas kernel on a
ported path is a CUDA kernel written by hand under ``csrc/``, built at first
use; its plain PyTorch version sits beside it and runs on CPU tensors.

Ported so far: the PointRCNN eval forward and post-processing
(``models.build_network``, ``models.api.apply_eval`` / ``post_process``).
"""
