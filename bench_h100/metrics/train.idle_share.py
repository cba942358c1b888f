"""The device's idle share over one profiled pass through the pool of train
steps: 1 − the union of its kernel, copy and set intervals over the span."""
LAYER = "device"
MOVES = "train_scans_per_s"


def read(ctx):
    prof = ctx.profile
    if not prof or prof["window_s"] <= 0 or prof["ops"] == 0:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100
