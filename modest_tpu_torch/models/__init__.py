"""Detector construction — port of ``modest_tpu/models/__init__.py``."""
from __future__ import annotations

import torch

from ..utils.config import Config
from .layers import init_parameters
from .pointrcnn import PointRCNN

GRID_MODELS = ("PointPillar", "SECONDNet", "PVRCNN", "SECONDNetIoU", "SECONDIoU", "VoxelRCNN",
               "PartA2", "PartA2Net")


def _grid_class(name: str):
    if name == "PVRCNN":
        from .pv_rcnn import PVRCNN

        return PVRCNN
    if name in ("SECONDNetIoU", "SECONDIoU"):
        from .second_iou import SECONDIoU

        return SECONDIoU
    if name == "VoxelRCNN":
        from .voxel_rcnn import VoxelRCNN

        return VoxelRCNN
    if name in ("PartA2", "PartA2Net"):
        from .part_a2 import PartA2

        return PartA2
    if name == "PointRCNN":  # with the UNetV2 backbone
        from .part_a2 import PartA2Free

        return PartA2Free
    from .grid_detectors import GridDetector

    return GridDetector


def _num_point_features(dataset) -> int:
    """The point width a dataset hands the model: x, y, z and its encoder's
    used features."""
    if getattr(dataset, "num_point_features", None) is not None:
        return int(dataset.num_point_features)
    encoder = getattr(dataset, "point_feature_encoder", None)
    return int(encoder.num_point_features) if encoder is not None else 4


def build_network(model_cfg, num_class: int, device="cuda", *, seed: int = 0, dataset=None):
    """Build a detector in eval mode on ``device``, with weights drawn from a
    ``torch.Generator`` seeded with ``seed``; load trained weights with
    ``load_state_dict``. The voxel and pillar detectors (``GRID_MODELS``:
    PointPillar, SECONDNet, PVRCNN, SECONDNetIoU, VoxelRCNN, PartA2, and
    the anchor-free Part-A2, NAME PointRCNN with the UNetV2 backbone) and
    the camera detector CaDDN take the data geometry from ``dataset`` (its
    ``point_cloud_range``, ``voxel_size`` and ``grid_size``, as the dataset
    classes record them, and the point width: its ``num_point_features``,
    else its encoder's, else 4; 5 on nuScenes and Waymo); PointPillar and
    SECONDNet take its ``class_names`` too, which a grouped anchor head
    needs. A CUDA device must exist unless the caller asks for the CPU:
    nothing falls back quietly."""
    cfg = Config(model_cfg)
    name = cfg.NAME
    backbone = cfg.get("BACKBONE_3D", {}).get("NAME", "")
    grid = name in GRID_MODELS or name == "CaDDN" or (name, backbone) == ("PointRCNN", "UNetV2")
    if not grid and (name, backbone) != ("PointRCNN", "PointNet2MSG"):
        raise NotImplementedError(f"modest_tpu_torch ports PointRCNN (PointNet2MSG or UNetV2 "
                                  f"backbone), {', '.join(GRID_MODELS)} and CaDDN, not {name} "
                                  f"/ {backbone}")
    if grid and getattr(dataset, "grid_size", None) is None:
        raise ValueError(f"{name} needs the data geometry: pass dataset= with "
                         "point_cloud_range, voxel_size and grid_size")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if name == "CaDDN":
        from .caddn import CaDDN

        model = CaDDN(cfg, num_class=num_class, point_cloud_range=dataset.point_cloud_range,
                      voxel_size=dataset.voxel_size, grid_size=dataset.grid_size)
    elif grid:
        kwargs = {}
        if name in ("PointPillar", "SECONDNet"):
            kwargs["class_names"] = tuple(getattr(dataset, "class_names", ()) or ()) or None
        model = _grid_class(name)(
            cfg, num_class=num_class,
            point_cloud_range=dataset.point_cloud_range, voxel_size=dataset.voxel_size,
            grid_size=dataset.grid_size,
            num_point_features=_num_point_features(dataset), **kwargs)
    else:
        model = PointRCNN(cfg, num_class=num_class)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
