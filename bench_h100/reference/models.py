"""Build the reference detector of a configuration and run its eval path."""
from __future__ import annotations

import torch

from .config import Config
from .grid_detectors import GridDetector, grid_post_process
from .pointrcnn import PointRCNN
from .pointrcnn import post_process as pointrcnn_post_process


def build(cfg: dict, geometry: dict, device) -> torch.nn.Module:
    """The reference detector of ``cfg`` (the whole configuration: MODEL,
    CLASS_NAMES) in eval mode on ``device``, its weights left to the caller.
    ``geometry`` holds point_cloud_range, voxel_size and grid_size."""
    model_cfg = Config(cfg["MODEL"])
    num_class = len(cfg["CLASS_NAMES"])
    if model_cfg.NAME == "PointRCNN":
        model = PointRCNN(model_cfg, num_class)
    elif model_cfg.NAME == "SECONDNet":
        model = GridDetector(model_cfg, num_class, geometry["point_cloud_range"],
                             geometry["voxel_size"], geometry["grid_size"],
                             num_point_features=4, class_names=tuple(cfg["CLASS_NAMES"]))
    else:
        raise NotImplementedError(f"the reference has no {model_cfg.NAME}")
    return model.to(device).eval()


def eval_forward(model, points, max_voxels: int | None = None, on_stage=None):
    """The eval forward's outputs and the post-processed finals of ``points``."""
    model.eval()
    with torch.inference_mode():
        if isinstance(model, GridDetector):
            out = model(points, on_stage=on_stage, max_voxels=max_voxels)
            final = grid_post_process(out, model.model_cfg.POST_PROCESSING)
        else:
            out = model(points, on_stage=on_stage)
            final = pointrcnn_post_process(out, model.model_cfg.POST_PROCESSING)
    return out, final
