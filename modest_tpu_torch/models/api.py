"""Model-family dispatch for the eval path — port of ``modest_tpu/models/api.py``
(PointRCNN only so far)."""
from __future__ import annotations

import torch

from .pointrcnn import post_process as _pointrcnn_post_process


def _check_pointrcnn(model_cfg):
    if model_cfg.NAME != "PointRCNN":
        raise NotImplementedError(f"modest_tpu_torch ports only PointRCNN, not {model_cfg.NAME}")


def apply_eval(model, model_cfg, points, on_stage=None):
    """Eval forward of ``model`` on ``points`` (B, N, 3+C), without autograd."""
    _check_pointrcnn(model_cfg)
    with torch.inference_mode():
        return model(points, on_stage=on_stage)


def post_process(out, model_cfg):
    _check_pointrcnn(model_cfg)
    with torch.inference_mode():
        final = _pointrcnn_post_process(out, model_cfg.POST_PROCESSING)
    final["rois"] = out.get("rois")
    return final
