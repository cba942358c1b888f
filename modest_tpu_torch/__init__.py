"""PyTorch/CUDA port of modest_tpu for NVIDIA Hopper (H100).

The JAX package ``modest_tpu`` stays the reference; this package mirrors its
file layout (``modest_tpu/<path>.py`` ↔ ``modest_tpu_torch/<path>.py``) and
imports only torch, numpy and the standard library. Every Pallas kernel on a
ported path is a CUDA kernel written by hand under ``csrc/``, built at first
use; its plain PyTorch version sits beside it and runs on CPU tensors.

Ported so far: the PointRCNN eval forward and post-processing
(``models.build_network``, ``models.api.apply_eval`` / ``post_process``), its
training (``data``, ``models.api.apply_train`` / ``compute_loss``,
``train``, ``cli.train``), the label-free seed path: the PP score
(``pipeline.pp_score``, ``cli.pre_compute_pp_score``) and the seed masks and
boxes (``pipeline.clustering``, ``pipeline.box_fit``, ``pipeline.seed_labels``,
``cli.generate_mask``), and the self-training round: detection eval
(``eval.kitti_eval``, ``train.loop.eval_one_epoch``, ``cli.test``,
``cli.evaluate``), label files and fusion (``cli.generate_label_files``,
``cli.combine_labels``, ``cli.gen_gt_mask``) and the driver
(``cli.self_train``); and the grid detectors PointPillars and SECOND
(``models.voxelize``, ``models.sparse_conv``, ``models.grid_detectors``),
which train, test and self-train through the same entry points. Training
and evaluation also run data-parallel in several processes, one device each
(``parallel``: the JAX package's sharded step over the global batch).
"""
