"""Mean ms a train step in the proposal stage (top-k and NMS, 9000 → 512),
by CUDA events."""
LAYER = "ops/iou3d.py (NMS)"
MOVES = "train_scans_per_s"


def read(ctx):
    return ctx.stage("proposal_nms")
