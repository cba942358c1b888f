"""FPS's share of its roofline: the least time the forward's FPS shapes need
at the card's peaks (harness/peaks.py::fps_bound, the work these shapes
need whatever implements it) over the device time of the FPS kernels in the
profiled span, per batch."""
from bench_h100.harness.peaks import fps_bound

LAYER = "ops/fps.py, csrc/fps.cu"
MOVES = "eval_scans_per_s"


def read(ctx):
    shapes = getattr(ctx.cell.recipe, "fps_shapes", None)
    prof = ctx.profile
    if shapes is None or not prof:
        return None
    spent = sum(s for name, s in prof["by_name"].items() if "fps" in name.lower())
    if spent <= 0:
        return None
    least_ms = sum(fps_bound(*shape)[0] for shape in shapes(ctx.cell.config, ctx.batch))
    return least_ms * 1e-3 * prof["batches"] / spent * 100
