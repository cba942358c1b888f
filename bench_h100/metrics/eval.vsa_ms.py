"""Mean ms a batch in PV-RCNN's voxel set abstraction, by CUDA events: every
``vsa_<source>`` stage (the BEV interpolation; the masked ball queries,
grouping, shared MLPs and max of each sparse scale and of the raw points)
and ``vsa_fusion`` (the fusion MLP and the PKW head)."""
LAYER = "models/pv_rcnn.py (VSA), ops/pointnet2_stack.py"
MOVES = "eval_scans_per_s"


def read(ctx):
    stages = [name for name in ctx.stage_ms if name.startswith("vsa_")]
    return ctx.stage(*stages) if stages else None
