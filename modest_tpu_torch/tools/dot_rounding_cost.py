"""What it costs on the card to round short dot products as XLA's CPU dot does.

    python -m modest_tpu_torch.tools.dot_rounding_cost [--reps 20]

The seed path's kNN distances, frame transforms and box-fit projections are
float32 dot products over 3 (or 2) terms. XLA's CPU backend rounds such a
dot as a fused multiply-add chain, fma(a2, b2, fma(a1, b1, a0 * b0)); copying
that rounding in PyTorch takes float64 steps (``f64_fma``). A plain float32
chain, ((a0*b0 + a1*b1) + a2*b2), takes float32 steps (``f32``). Both round
the same on the card and on the CPU; only ``f64_fma`` also gives the JAX
package's bits. The port takes ``f32``. This probe times both on one card
at the shapes the seed path gives them, per call and per unit of the path
(a group of 4 frames for the kNN and the box-fit scan, an origin frame for
the transform), and counts how many results differ. Prints one JSON line.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..utils.device import device_ms

# (name, a shape, b shape, terms, calls per path unit, unit)
SHAPES = (
    # kNN cross term: (B, 256 queries, 1) x (B, 1, 8192 candidates), 192 chunks
    # of a group of 4 frames padded to 49152 points
    ("knn_cross", (4, 256, 1), (4, 1, 8192), 3, 192, "group of 4 frames"),
    # PP frame transform: 40 frames of 131072 points, one call per coordinate
    ("pp_transform", (40, 1), (40, 131072), 3, 3, "origin"),
    # box-fit angle scan: 36 clusters of 1024 padded points x 901 angles, u and v
    ("box_scan", (36, 1024, 1), (901,), 2, 6, "group of 4 frames"),
)


def dot_f64_fma(a, b):
    s = a[0] * b[0]
    for ai, bi in zip(a[1:], b[1:]):
        s = (ai.double() * bi.double() + s.double()).float()
    return s


def dot_f32(a, b):
    s = a[0] * b[0]
    for ai, bi in zip(a[1:], b[1:]):
        s = s + ai * bi
    return s


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dot_rounding_cost needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for name, a_shape, b_shape, terms, calls, unit in SHAPES:
        a = [((torch.rand(a_shape, generator=gen) - 0.5) * 140).cuda() for _ in range(terms)]
        b = [((torch.rand(b_shape, generator=gen) - 0.5) * 140).cuda() for _ in range(terms)]
        f64_ms = device_ms(lambda: dot_f64_fma(a, b), dev, args.reps)
        f32_ms = device_ms(lambda: dot_f32(a, b), dev, args.reps)
        differ = float((dot_f64_fma(a, b) != dot_f32(a, b)).float().mean())
        rows.append({"name": name, "shape": list(torch.broadcast_shapes(a_shape, b_shape)),
                     "terms": terms, "f64_fma_ms": f64_ms, "f32_ms": f32_ms,
                     "calls_per_unit": calls, "unit": unit,
                     "f64_fma_ms_per_unit": f64_ms * calls, "f32_ms_per_unit": f32_ms * calls,
                     "share_of_results_that_differ": differ})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"dot_rounding_cost": rows, "reps": args.reps, "card": card}))


if __name__ == "__main__":
    main()
