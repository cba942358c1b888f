"""Mean ms a batch in the PointNet++ backbone stage, by CUDA events."""
LAYER = "models/pointnet2_backbone.py, ops/pointnet2.py"
MOVES = "eval_scans_per_s"


def read(ctx):
    return ctx.stage("backbone")
