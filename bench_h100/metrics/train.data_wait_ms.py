"""Mean ms a train step's host waits for its batch from the program's loader
(``data/loader.py``'s workers and ``prefetch_to_device``), by the host's
clock, over the window's steps outside the profiled pass."""
LAYER = "data/loader.py"
MOVES = "train_scans_per_s"


def read(ctx):
    return ctx.data_wait_ms
