"""Mean ms a train step in ``loss.backward()``, by CUDA events."""
LAYER = "train/state.py (backward)"
MOVES = "train_scans_per_s"


def read(ctx):
    return ctx.stage("backward")
