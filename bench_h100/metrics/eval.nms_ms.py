"""Mean ms a batch in the NMS stages, by CUDA events: the proposal NMS stage
where the detector has one, and the harness's span around ``post_process``
(score threshold, top-k and the post NMS)."""
LAYER = "ops/iou3d.py (NMS)"
MOVES = "eval_scans_per_s"


def read(ctx):
    post = ctx.stage("post_process")
    if post is None:
        return None
    return post + (ctx.stage("proposal_nms") or 0.0)
