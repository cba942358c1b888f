"""PointRCNN on Lyft (``pointrcnn_dynamic_obj.json``): the paper's flagship
detector, a point-based two-stage model: the PointNet++ backbone (FPS, ball
query, grouping, shared MLPs), the point head, the proposal NMS (9000 → 100
at IoU 0.85 in eval), RoI point pooling, the RoI head's SA tower, and the
post NMS (4096 → 500 at IoU 0.1).

How the port and the reference are built from the configuration, how the
benchmark's weights reach both, and how their outputs are compared stage by
stage: the point logits (backbone and point head), the RoIs (proposal NMS),
the final boxes (RoI pooling, RoI head, post NMS).
"""
from __future__ import annotations


from bench_h100.harness import compare
from bench_h100.reference import models as reference_models
from bench_h100.traffic.weights import seeded_weights

STAGES = ("backbone", "point_head", "proposal_nms", "roi_pool", "roi_head")


def points_per_scan(cfg: dict, mode: str) -> int:
    for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "sample_points":
            return int(proc["NUM_POINTS"][mode])
    raise ValueError("the configuration samples no fixed number of points")


def geometry(cfg: dict) -> dict:
    return {"point_cloud_range": cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"]}


def build_port(cfg: dict, device):
    from modest_tpu_torch.models import build_network

    return build_network(cfg["MODEL"], len(cfg["CLASS_NAMES"]), device=device)


def build_reference(cfg: dict, device):
    return reference_models.build(cfg, geometry(cfg), device)


def prepare_weights(reference, cfg: dict, seed: int, pool, gt_boxes) -> None:
    seeded_weights(reference, seed)


def reference_eval(reference, cfg: dict, points):
    return reference_models.eval_forward(reference, points)


def fps_shapes(cfg: dict, batch: int):
    """(B, N, npoint) of every FPS call of one eval forward: the backbone's
    SA levels, then the RoI head's SA levels over every RoI's pooled points."""
    model = cfg["MODEL"]
    shapes, n = [], points_per_scan(cfg, "test")
    for npoint in model["BACKBONE_3D"]["SA_CONFIG"]["NPOINTS"]:
        shapes.append((batch, n, int(npoint)))
        n = int(npoint)
    rois = batch * int(model["ROI_HEAD"]["NMS_CONFIG"]["TEST"]["NMS_POST_MAXSIZE"])
    n = int(model["ROI_HEAD"]["ROI_POINT_POOL"]["NUM_SAMPLED_POINTS"])
    for npoint in model["ROI_HEAD"]["SA_CONFIG"]["NPOINTS"]:
        if int(npoint) > 0:
            shapes.append((rois, n, int(npoint)))
            n = int(npoint)
    return shapes


def compare_batch(tally: compare.Tally, got_out, got_final, want_out, want_final) -> None:
    tally.gap("point_logit_gap", compare.widest_gap(got_out["point_cls_preds"],
                                                    want_out["point_cls_preds"]))
    rois = {"valid": "roi_valid", "boxes": "rois", "scores": "roi_scores"}
    tally.miss("roi_miss", *compare.box_miss(
        {k: got_out[v] for k, v in rois.items()}, {k: want_out[v] for k, v in rois.items()},
        labels=False))
    tally.miss("final_miss", *compare.box_miss(got_final, want_final))
