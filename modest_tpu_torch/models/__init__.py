"""Detector construction — port of ``modest_tpu/models/__init__.py``."""
from __future__ import annotations

import torch

from ..utils.config import Config
from .layers import init_parameters
from .pointrcnn import PointRCNN

GRID_MODELS = ("PointPillar", "SECONDNet")


def build_network(model_cfg, num_class: int, device="cuda", *, seed: int = 0, dataset=None):
    """Build a detector in eval mode on ``device``, with weights drawn from a
    ``torch.Generator`` seeded with ``seed``; load trained weights with
    ``load_state_dict``. The grid detectors (PointPillar, SECONDNet) take
    the data geometry from ``dataset`` (its ``point_cloud_range``,
    ``voxel_size`` and ``grid_size``, as the dataset classes record them).
    A CUDA device must exist unless the caller asks for the CPU: nothing
    falls back quietly."""
    cfg = Config(model_cfg)
    name = cfg.NAME
    backbone = cfg.get("BACKBONE_3D", {}).get("NAME", "")
    grid = name in GRID_MODELS
    if not grid and (name, backbone) != ("PointRCNN", "PointNet2MSG"):
        raise NotImplementedError(f"modest_tpu_torch ports PointRCNN (PointNet2MSG backbone), "
                                  f"PointPillar and SECONDNet, not {name} / {backbone}")
    if grid and getattr(dataset, "grid_size", None) is None:
        raise ValueError(f"{name} needs the data geometry: pass dataset= with "
                         "point_cloud_range, voxel_size and grid_size")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if grid:
        from .grid_detectors import GridDetector

        model = GridDetector(cfg, num_class=num_class,
                             point_cloud_range=dataset.point_cloud_range,
                             voxel_size=dataset.voxel_size, grid_size=dataset.grid_size)
    else:
        model = PointRCNN(cfg, num_class=num_class)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
