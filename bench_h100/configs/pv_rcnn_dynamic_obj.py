"""PV-RCNN on Lyft (``pv_rcnn_dynamic_obj.json``): SECOND's stage 1
(voxelization at the port's 16000-voxel cap, VoxelBackBone8x, the BEV
backbone, the anchor head), FPS of 2048 keypoints out of each scan's 65536
points, the voxel set abstraction (the BEV map by bilinear interpolation,
then masked ball queries at two radii over the four sparse scales and the
raw points, each with its shared MLP and a max), the PKW-weighted fusion,
the proposal NMS (1024 → 100 at IoU 0.7), the RoI-grid pool (6³ grid points
a RoI, two more ball queries over the keypoints), the RoI head, and the
post NMS (4096 → 500 at IoU 0.1).

How the port and the reference (``reference/pv_rcnn.py``) are built from the
configuration, how the benchmark's weights reach both (drawn from the seed,
then calibrated on the reference over the run's pool: stage 1 as SECOND's,
by ``traffic/weights.py::calibrate_grid``; then the RoI head here), and how
their outputs are compared stage by stage: the dense class logits (stage 1),
the keypoints (FPS), the PKW-weighted keypoint features (VSA), the RoIs
(proposal NMS) and the final boxes (grid pool, RoI head, post NMS).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from bench_h100.configs import second_dynamic_obj as second
from bench_h100.configs.second_dynamic_obj import geometry, max_voxels, points_per_scan
from bench_h100.harness import compare
from bench_h100.reference.config import Config
from bench_h100.reference.pv_rcnn import PVRCNN, eval_forward
from bench_h100.traffic.weights import BOX_RESIDUAL_STD, calibrate_grid, seeded_weights

# the port's stages for this configuration (its ``stages``)
STAGES = ("voxelize", "backbone_3d", "backbone_2d", "dense_head", "keypoint_fps", "vsa_bev",
          "vsa_x_conv1", "vsa_x_conv2", "vsa_x_conv3", "vsa_x_conv4", "vsa_raw_points",
          "vsa_fusion", "proposal", "grid_pool", "roi_head")
# a calibrated RoI head: the share of a scan's RoIs, over the pool, that
# scores above the score threshold
ROI_SHARE = 0.5


def build_port(cfg: dict, device):
    """The port's PV-RCNN, built as SECOND's recipe builds it (through
    ``build_network``, refusing a voxel-cap mismatch), its forward's outputs
    given the PKW-weighted keypoint features as ``keypoint_features``: the
    third input of its RoI-grid pool, read by a hook."""
    model = second.build_port(cfg, device)
    held = []
    model.roi_grid_pool.register_forward_pre_hook(lambda module, args: held.append(args[2]))

    def put(module, args, out):
        out["keypoint_features"] = held.pop()

    model.register_forward_hook(put)
    return model


def build_reference(cfg: dict, device):
    geo = geometry(cfg)
    model = PVRCNN(Config(cfg["MODEL"]), len(cfg["CLASS_NAMES"]), geo["point_cloud_range"],
                   geo["voxel_size"], geo["grid_size"], num_point_features=4)
    return model.to(device).eval()


def reference_eval(reference, cfg: dict, points):
    return eval_forward(reference, points, max_voxels(cfg))


def prepare_weights(reference, cfg: dict, seed: int, pool, gt_boxes) -> None:
    """Seeded weights, stage 1 calibrated as SECOND's, then the RoI head."""
    seeded_weights(reference, seed)
    cap = max_voxels(cfg)
    thresh = float(cfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"])

    def stats_forward(points, gt):  # the eval forward on batch statistics
        reference.train()
        return reference(points, max_voxels=cap)

    calibrate_grid(reference, stats_forward, lambda p: reference_eval(reference, cfg, p),
                   pool, gt_boxes, thresh)
    calibrate_roi_head(reference, pool, cap, thresh)


@torch.no_grad()
def calibrate_roi_head(reference, pool, cap: int, score_thresh: float) -> None:
    """The RoI head's batch norms from one pass over the pool's first batch
    with the rest of the model in eval mode; then, over eval passes of the
    whole pool, ``rcnn_reg``'s output weights scaled so that every residual
    spreads by ``BOX_RESIDUAL_STD`` around a zero bias, and ``rcnn_cls``'s
    bias moved so that ``ROI_SHARE`` of the valid RoIs score above
    ``score_thresh``. So the refined boxes that reach the post NMS, their
    number and their sizes, are alike for every seed."""
    head = (reference.roi_shared_fc, reference.rcnn_cls, reference.rcnn_reg)
    bns = [m for h in head for m in h.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    reference.eval()
    for h in head:
        h.train()
    for m in bns:
        m.momentum = 1.0
    reference(pool[0], max_voxels=cap)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    reference.eval()
    cls_layer, reg_layer = reference.rcnn_cls[-1], reference.rcnn_reg[-1]
    outputs = {"cls": [], "reg": []}
    hooks = [layer.register_forward_hook(lambda m, i, out, key=key: outputs[key].append(out))
             for key, layer in (("cls", cls_layer), ("reg", reg_layer))]
    valid = [reference(points, max_voxels=cap)["roi_valid"].reshape(-1) for points in pool]
    for hook in hooks:
        hook.remove()
    valid = torch.cat(valid)
    reg = torch.cat([o.reshape(-1, o.shape[-1]) for o in outputs["reg"]])[valid]
    reg_layer.weight.mul_((BOX_RESIDUAL_STD / reg.std(dim=0).clamp_min(1e-12))[:, None])
    reg_layer.bias.zero_()
    logits = torch.cat([o.reshape(-1) for o in outputs["cls"]])[valid]
    k = min(max(1, round(ROI_SHARE * logits.numel())), logits.numel() - 1)
    top = logits.topk(k + 1).values
    threshold = math.log(score_thresh / (1 - score_thresh))
    cls_layer.bias += threshold - (top[k - 1] + top[k]) / 2


def fps_shapes(cfg: dict, batch: int):
    """(B, N, npoint) of the forward's one FPS call: the keypoints."""
    return [(batch, points_per_scan(cfg, "test"), int(cfg["MODEL"]["PFE"]["NUM_KEYPOINTS"]))]


def compare_batch(tally: compare.Tally, got_out, got_final, want_out, want_final) -> None:
    tally.gap("dense_logit_gap", compare.widest_gap(got_out["cls_preds"], want_out["cls_preds"]))
    kp_got, kp_want = got_out["keypoints"], want_out["keypoints"]
    tally.miss("keypoint_miss", int((kp_got != kp_want).any(dim=-1).sum()),
               kp_want.shape[0] * kp_want.shape[1])
    tally.gap("vsa_feature_gap", compare.widest_gap(got_out["keypoint_features"],
                                                    want_out["keypoint_features"]))
    rois = {"valid": "roi_valid", "boxes": "rois", "scores": "roi_scores"}
    tally.miss("roi_miss", *compare.box_miss(
        {k: got_out[v] for k, v in rois.items()}, {k: want_out[v] for k, v in rois.items()},
        labels=False))
    tally.miss("final_miss", *compare.box_miss(got_final, want_final))
