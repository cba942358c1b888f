"""Mean ms a batch in PV-RCNN's RoI-grid pool stage, by CUDA events: the
grid points of every RoI, and the masked ball queries, grouping, shared
MLPs and max over the keypoints around them."""
LAYER = "models/pv_rcnn.py (RoI-grid pool), ops/pointnet2_stack.py"
MOVES = "eval_scans_per_s"


def read(ctx):
    return ctx.stage("grid_pool")
