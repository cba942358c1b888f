"""SECOND on Lyft (``second_dynamic_obj.json``): the paper's grid detector:
voxelization (16000 voxels a scan, the port's cap), the sparse 3D backbone
(VoxelBackBone8x), the BEV backbone, the single anchor head (90,400
anchors), and the post NMS (4096 → 500 at IoU 0.01).

How the port and the reference are built from the configuration, how the
benchmark's weights reach both (drawn from the seed, then calibrated on the
reference over the run's pool: batch-norm statistics from one
train-mode pass, box residuals spread by 0.1, 1024 anchors a scan over the
pool above the score threshold; ``traffic/weights.py::calibrate_grid``), and
how their outputs are compared stage by stage: the dense class logits
(voxelize, sparse backbone, BEV backbone, dense head) and the final boxes
(post NMS).
"""
from __future__ import annotations


from bench_h100.harness import compare
from bench_h100.reference import models as reference_models
from bench_h100.traffic.weights import calibrate_grid, seeded_weights

STAGES = ("voxelize", "backbone_3d", "backbone_2d", "dense_head")


def _voxel_processor(cfg: dict) -> dict:
    for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "transform_points_to_voxels":
            return proc
    raise ValueError("the configuration has no voxel processor")


def points_per_scan(cfg: dict, mode: str) -> int:
    for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "sample_points":
            return int(proc["NUM_POINTS"][mode])
    raise ValueError("the configuration samples no fixed number of points")


def max_voxels(cfg: dict, mode: str = "test") -> int:
    return int(_voxel_processor(cfg)["MAX_NUMBER_OF_VOXELS"][mode])


def geometry(cfg: dict) -> dict:
    pcr = [float(v) for v in cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"]]
    voxel = [float(v) for v in _voxel_processor(cfg)["VOXEL_SIZE"]]
    grid = [int(round((pcr[i + 3] - pcr[i]) / voxel[i])) for i in range(3)]
    return {"point_cloud_range": pcr, "voxel_size": voxel, "grid_size": grid}


def build_port(cfg: dict, device):
    from types import SimpleNamespace

    from modest_tpu_torch.models import build_network
    from modest_tpu_torch.models.grid_detectors import MAX_VOXELS

    if MAX_VOXELS != max_voxels(cfg):
        raise ValueError(f"the port caps voxels at {MAX_VOXELS}, the configuration as run at "
                         f"{max_voxels(cfg)}")
    dataset = SimpleNamespace(**geometry(cfg), num_point_features=4,
                              class_names=list(cfg["CLASS_NAMES"]))
    return build_network(cfg["MODEL"], len(cfg["CLASS_NAMES"]), device=device, dataset=dataset)


def build_reference(cfg: dict, device):
    return reference_models.build(cfg, geometry(cfg), device)


def prepare_weights(reference, cfg: dict, seed: int, pool, gt_boxes) -> None:
    """Seeded weights, then the heads calibrated over the run's whole pool."""
    seeded_weights(reference, seed)
    cap = max_voxels(cfg)

    def train_forward(p, g):
        reference.train()
        return reference(p, g, max_voxels=cap)

    calibrate_grid(reference, train_forward,
                   lambda p: reference_models.eval_forward(reference, p, max_voxels=cap),
                   pool, gt_boxes, float(cfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"]))


def reference_eval(reference, cfg: dict, points):
    return reference_models.eval_forward(reference, points, max_voxels=max_voxels(cfg))


def compare_batch(tally: compare.Tally, got_out, got_final, want_out, want_final) -> None:
    tally.gap("dense_logit_gap", compare.widest_gap(got_out["cls_preds"], want_out["cls_preds"]))
    tally.miss("final_miss", *compare.box_miss(got_final, want_final))
