"""PyTorch/CUDA port of modest_tpu for NVIDIA Hopper (H100).

The JAX package ``modest_tpu`` stays the reference; this package mirrors its
file layout (``modest_tpu/<path>.py`` ↔ ``modest_tpu_torch/<path>.py``) and
imports only torch, numpy and the standard library. Every Pallas kernel on a
ported path is a CUDA kernel written by hand under ``csrc/``, built at first
use; its plain PyTorch version sits beside it and runs on CPU tensors.

Ported so far: the PointRCNN eval forward and post-processing
(``models.build_network``, ``models.api.apply_eval`` / ``post_process``), its
training (``data``, ``models.api.apply_train`` / ``compute_loss``,
``train``, ``cli.train``), and the label-free seed path: the PP score
(``pipeline.pp_score``, ``cli.pre_compute_pp_score``) and the seed masks and
boxes (``pipeline.clustering``, ``pipeline.box_fit``, ``pipeline.seed_labels``,
``cli.generate_mask``).
"""
