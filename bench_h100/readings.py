"""The readings that a cell's comparison limits are set from, on the card.

    python3 bench_h100/readings.py --workload <cell> --seeds 1 2 3 [--seconds 2]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (long enough for a train cell's drawn step), then the numbers that decide ``correct`` for the port against
the reference (the sound reading), and for the control: the reference
itself computed with TF32 on (the precision below the float32 the
configurations state) put in the port's place. A train cell also reads the
fault of half of each batch left out, planted in the reference put in the
port's place. Prints one JSON line a seed and a summary line: the largest
sound reading and the smallest control (and fault) reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    import torch

    from bench_h100.harness import manifest
    from bench_h100.harness.detector import EvalCell
    from bench_h100.harness.trainer import TrainCell

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.load_cell(ROOT / "BENCHMARK.json", args.workload)
    sound, control = {}, {}
    fault = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["mode"] == "eval":
            runner = EvalCell(cell, seed)
            runner.setup()
            w = runner.window(args.seconds)
            runner.release_port()
            t1 = time.perf_counter()
            want, _ = runner.reference_outputs()
            t2 = time.perf_counter()
            got_tf32, _ = runner.reference_outputs(tf32=True)
            s = runner.numbers(runner.kept, want)
            c = runner.numbers(got_tf32, want)
            row = {"finals": [int(runner.kept[p][1]["valid"].sum()) for p in runner.sampled],
                   "batches": w["batches"]}
        else:
            runner = TrainCell(cell, seed)
            runner.setup()
            w = runner.window(args.seconds)
            runner.release_port()
            t1 = time.perf_counter()
            want = runner.reference_readings()
            t2 = time.perf_counter()
            s = runner.numbers(runner.port_readings(want["b1"]), want)
            c = runner.numbers(runner.reference_readings(tf32=True), want)
            f = runner.numbers(runner.reference_readings(half_batch=True), want)
            row = {"half_batch": f, "losses": want["losses"], "window_step": runner.window_step,
                   "steps": w["batches"]}
            for k, v in f.items():
                fault[k] = min(fault.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "sound": s, "control": c, **row,
                          "setup_s": t1 - t0, "reference_s": t2 - t1}), flush=True)
        for k, v in s.items():
            sound[k] = max(sound.get(k, 0.0), v)
        for k, v in c.items():
            control[k] = min(control.get(k, float("inf")), v)
        del runner
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "sound_max": sound, "control_min": control, "half_batch_min": fault,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
