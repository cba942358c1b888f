"""Mean ms a batch in voxelization and the sparse 3D backbone, by CUDA
events."""
LAYER = "models/voxelize.py, models/sparse_conv.py"
MOVES = "eval_scans_per_s"


def read(ctx):
    return ctx.stage("voxelize", "backbone_3d")
