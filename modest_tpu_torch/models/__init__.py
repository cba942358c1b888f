"""Detector construction — port of ``modest_tpu/models/__init__.py``."""
from __future__ import annotations

import torch

from ..utils.config import Config
from .layers import init_parameters
from .pointrcnn import PointRCNN


def build_network(model_cfg, num_class: int, device="cuda", *, seed: int = 0):
    """Build a detector in eval mode on ``device``, with weights drawn from a
    ``torch.Generator`` seeded with ``seed``; load trained weights with
    ``load_state_dict``. A CUDA device must exist unless the caller asks
    for the CPU: nothing falls back quietly."""
    cfg = Config(model_cfg)
    name = cfg.NAME
    backbone = cfg.get("BACKBONE_3D", {}).get("NAME", "")
    if name != "PointRCNN" or backbone != "PointNet2MSG":
        raise NotImplementedError(f"modest_tpu_torch ports only PointRCNN with a PointNet2MSG "
                                  f"backbone, not {name} / {backbone}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    model = PointRCNN(cfg, num_class=num_class)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
