"""Probe the PointRCNN train step at full width: where a diverging run first
goes non-finite, and where one step's gradients on the card part from the
CPU path's.

    python -m modest_tpu_torch.tools.train_probe diverge [--device cpu]
    python -m modest_tpu_torch.tools.train_probe grad_gap

Both run from the repository's root on ``chip_smoke.py``'s synthetic training
set (16 Lyft-sized scans, ``tools/synth_kitti.py``), its first batch at
B = 2 × 12288 and the flagship config, and print one JSON line per result.

``diverge`` takes ``chip_smoke.OVERFIT_STEPS`` (20) optimizer steps on that
one batch, with the RoI-sampler draws a run takes at each step and the
flagship's one-cycle schedule squeezed into those steps (about 10 s a step
on the CPU). Each step prints its losses, the learning rate, the
gradients' global norm, the largest parameter and the largest entry of every
output of the forward. At the first step with a non-finite value it restores
the state from before that step, runs the step again with a forward hook on
every module and autograd's anomaly mode, and prints the first module whose
output is non-finite and the backward function that first returned one.

``grad_gap`` runs one step's forward and backward from the same weights,
batch and draws on the CPU and on the card in float32, and the backbone and
point head once more on the CPU in float64 with the float32 run's point
choices (FPS and three-NN pick in float32, the ball queries are replayed:
``PinnedIndices``, ``BallQueryTape``). It prints, per ball query, the
(center, slot) indices and the centers on which the card differs from the
CPU; per grouped max-pool, the (center, channel) maxima taken from another
point; and the gradients' errors card vs CPU, CPU vs float64 and card vs
float64, each relative to the second one's norm.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import shutil
import tempfile
import warnings
from pathlib import Path

import numpy as np
import torch

from ..models import api, build_network
from ..models.layers import SharedMLP
from ..models.pointrcnn import point_losses
from ..ops import pointnet2 as p2
from ..train.state import create_train_state, step_roi_draws


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _tensors(obj, prefix=""):
    """(name, tensor) for every floating tensor in a nest of dicts, lists
    and tuples."""
    if torch.is_tensor(obj):
        if obj.is_floating_point():
            yield prefix, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _tensors(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _tensors(v, f"{prefix}.{i}")


def _absmax(t) -> float:
    t = t.detach()
    fin = t[torch.isfinite(t)]
    return float(fin.abs().max()) if fin.numel() else 0.0


def make_train_set(root: Path):
    """chip_smoke.py's training set in ``root``."""
    import chip_smoke as cs
    from ..configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from ..data.kitti_dataset import create_kitti_infos
    from ..tools.synth_kitti import make_dataset
    from ..utils.config import Config

    make_dataset(root, n_train=cs.TRAIN_SCANS, n_val=0, seed=0, full_density=True)
    create_kitti_infos(Config(POINTRCNN_DYNAMIC_OBJ_FULL).DATA_CONFIG, ["Dynamic"], root, root,
                       if_val=False)


def _forward_loss(model, model_cfg, batch, draws):
    out = api.apply_train(model, model_cfg, batch["points"], batch["gt_boxes"], roi_draws=draws)
    loss, metrics = api.compute_loss(out, batch["gt_boxes"], model_cfg, num_class=1)
    return out, loss, metrics


def one_step(state, model_cfg, batch, draws):
    """One optimizer step as ``train.state.train_step`` takes it, and a
    record of what it saw."""
    model = state.model
    lr = state.optimizer.current_lr()
    for p in model.parameters():
        p.grad = None
    out, loss, metrics = _forward_loss(model, model_cfg, batch, draws)
    loss.backward()
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                       if p.grad is not None)
    norm = float(state.optimizer.step())
    named = dict(_tensors(out))
    rec = {"step": state.step - 1, "lr": lr, **{k: v.item() for k, v in metrics.items()},
           "grad_norm": norm, "grads_finite": grads_finite,
           "params_finite": all(bool(torch.isfinite(p).all()) for p in model.parameters()),
           "param_absmax": max(_absmax(p) for p in model.parameters()),
           "out_absmax": {k: _absmax(v) for k, v in named.items()},
           "out_nonfinite": {k: int((~torch.isfinite(v)).sum()) for k, v in named.items()
                             if not bool(torch.isfinite(v).all())}}
    rec["finite"] = (grads_finite and rec["params_finite"] and not rec["out_nonfinite"]
                     and all(np.isfinite(v.item()) for v in metrics.values()))
    return rec


def locate(model, model_cfg, batch, draws) -> dict:
    """The first module (in call order) with finite inputs and a non-finite
    output, and the backward function that first returned a non-finite
    gradient under ``torch.autograd.detect_anomaly``."""
    first = []

    def hook(name, module, inputs, output):
        if first:
            return
        bad_out = [k for k, t in _tensors(output) if not bool(torch.isfinite(t).all())]
        if bad_out:
            bad_in = [k for k, t in _tensors(inputs) if not bool(torch.isfinite(t).all())]
            first.append({"module": name, "type": type(module).__name__,
                          "inputs_nonfinite": bad_in, "outputs_nonfinite": bad_out})

    handles = [m.register_forward_hook(functools.partial(hook, name))
               for name, m in model.named_modules() if name]
    anomaly, forward_trace, out_bad, metric_vals = None, None, {}, {}
    for p in model.parameters():
        p.grad = None
    try:
        with warnings.catch_warnings(record=True) as caught, torch.autograd.detect_anomaly():
            warnings.simplefilter("always")
            try:
                out, loss, metrics = _forward_loss(model, model_cfg, batch, draws)
                out_bad = {k: int((~torch.isfinite(v)).sum()) for k, v in _tensors(out)
                           if not bool(torch.isfinite(v).all())}
                metric_vals = {k: v.item() for k, v in metrics.items()}
                loss.backward()
            except RuntimeError as e:
                anomaly = str(e)
            for w in caught:
                text = str(w.message)
                if "Traceback of forward call" in text:
                    forward_trace = text[-3000:]
    finally:
        for h in handles:
            h.remove()
    return {"first_nonfinite_module": first[0] if first else None,
            "out_nonfinite": out_bad, "metrics": metric_vals, "backward_anomaly": anomaly,
            "anomaly_forward_trace": forward_trace}


def diverge(dev, cfg, batch, steps: int) -> None:
    """``steps`` steps on ``batch`` (on ``dev``) from chip_smoke.py's overfit
    weights, each step with the RoI-sampler draws a run takes at that step,
    the one-cycle schedule squeezed into those steps."""
    model = build_network(cfg.MODEL, 1, device=dev, seed=1)
    state = create_train_state(model, cfg.OPTIMIZATION, steps)
    for _ in range(steps):
        draws = step_roi_draws(cfg.MODEL, batch["points"].shape[0], state.step, 666, dev)
        before = (copy.deepcopy(model.state_dict()), copy.deepcopy(state.optimizer.state_dict()))
        rec = one_step(state, cfg.MODEL, batch, draws)
        emit({"probe": "diverge", "device": str(dev), "schedule_steps": steps, **rec})
        if not rec["finite"]:
            model.load_state_dict(before[0])
            state.optimizer.load_state_dict(before[1])
            emit({"probe": "diverge_locate", "device": str(dev), "step": rec["step"],
                  **locate(model, cfg.MODEL, batch, draws)})
            return


class BallQueryTape:
    """Records every ball query's (idx, valid) in call order; given the
    records of another run, counts where this run's indices differ from
    them and, with ``substitute``, hands those indices on in place of its
    own. Used as a context manager around a forward."""

    def __init__(self, reference=None, substitute: bool = False):
        self.reference, self.substitute = reference, substitute
        self.calls, self.differ = [], []

    def __enter__(self):
        self._own = p2.ball_query_from_dist2
        p2.ball_query_from_dist2 = self
        return self

    def __exit__(self, *exc):
        p2.ball_query_from_dist2 = self._own

    def __call__(self, d2, radius, nsample):
        idx, valid = self._own(d2, radius, nsample)
        if self.reference is not None:
            ref_idx, ref_valid = self.reference[len(self.calls)]
            same = idx.cpu() == ref_idx
            self.differ.append({"shape": list(idx.shape), "radius": radius,
                                "slots_differ": int((~same).sum()),
                                "centers_differ": int((~same.all(-1)).sum())})
            if self.substitute:
                idx, valid = ref_idx.to(idx.device), ref_valid.to(valid.device)
        self.calls.append((idx.cpu(), valid.cpu()))
        return idx, valid


def _pool_sources(model, tape):
    """Forward hooks on the grouped MLPs: after each, the point each
    (center, channel) maximum came from (the ball query's index at the
    argmax slot)."""
    sources = []

    def hook(module, inputs, output):
        idx = tape.calls[-1][0]
        slot = output.detach().argmax(dim=2).cpu()  # (B, M, C)
        sources.append(torch.gather(idx, 2, slot))

    grouped = [m for name, m in model.named_modules()
               if isinstance(m, SharedMLP) and ".mlps." in name
               and getattr(model.get_submodule(name.rsplit(".mlps.", 1)[0]), "npoint", None)]
    return sources, [m.register_forward_hook(hook) for m in grouped]


class PinnedIndices:
    """Within the context FPS and three-NN choose their points in float32
    whatever the inputs' type, so a float64 run picks the points a float32
    run on the same inputs picks."""

    def __enter__(self):
        self._fps, self._three_nn = p2.furthest_point_sample, p2.three_nn
        p2.furthest_point_sample = lambda xyz, npoint: self._fps(xyz.float(), npoint)
        p2.three_nn = self.three_nn
        return self

    def __exit__(self, *exc):
        p2.furthest_point_sample, p2.three_nn = self._fps, self._three_nn

    def three_nn(self, unknown, known):
        _, idx = self._three_nn(unknown.float(), known.float())
        b, n, _ = idx.shape
        nbr = p2.gather_points(known, idx.reshape(b, -1)).reshape(b, n, 3, 3)
        return torch.sqrt(p2._sq_norm(nbr - unknown[:, :, None, :])), idx


def _grads(model):
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def _run(model_cfg, weights, batch, draws, where, reference=None):
    """One step's forward and backward on ``where``, its ball queries
    taped (and counted against ``reference``)."""
    model = build_network(model_cfg, 1, device=where, seed=0)
    model.load_state_dict(weights)
    points, gt = batch["points"].to(where), batch["gt_boxes"].to(where)
    d = {k: v.to(where) for k, v in draws.items()}
    with BallQueryTape(reference) as tape:
        sources, handles = _pool_sources(model, tape)
        out, loss, metrics = _forward_loss(model, model_cfg, {"points": points, "gt_boxes": gt},
                                           d)
        for h in handles:
            h.remove()
    loss.backward()
    return {"tape": tape, "sources": sources, "rois": out["rois"].detach().cpu(),
            "metrics": {k: v.item() for k, v in metrics.items()}, "grads": _grads(model)}


def point_run_float64(model_cfg, weights, batch, ball_queries):
    """The backbone's and point head's gradients of the point-head losses
    (the RoI head's input is detached, so the whole loss gives these) in
    float64 on the CPU, with the float32 run's choices: FPS and three-NN
    pick in float32, the ball queries are ``ball_queries``."""
    model = build_network(model_cfg, 1, device="cpu", seed=0)
    model.load_state_dict(weights)
    model.double().train()
    points, gt = batch["points"].cpu().double(), batch["gt_boxes"].cpu().double()
    with BallQueryTape(ball_queries, substitute=True) as tape, PinnedIndices():
        sources, handles = _pool_sources(model, tape)
        feats = model.backbone_3d(points)
        for h in handles:
            h.remove()
    cls, box = model.point_head(feats)
    out = {"point_xyz": points[..., :3], "point_cls_preds": cls, "point_box_preds": box}
    loss_cls, loss_box, pos_num = point_losses(out, gt, model_cfg, num_class=1)
    (loss_cls + loss_box).backward()
    return {"tape": tape, "sources": sources, "grads": _grads(model),
            "metrics": {"point_loss_cls": loss_cls.item(), "point_loss_box": loss_box.item(),
                        "point_pos_num": pos_num.item()}}


def grad_errors(grads, ref) -> dict:
    """Each gradient's error as a share of the reference gradient's norm."""
    return {n: float((g - ref[n]).norm() / ref[n].norm().clamp_min(1e-30))
            for n, g in grads.items() if n in ref}


def summarise(errs: dict) -> dict:
    parts = {"backbone_point_head": [n for n in errs
                                     if n.startswith(("backbone_3d.", "point_head."))],
             "roi_head": [n for n in errs if n.startswith("roi_head.")]}
    out = {}
    for part, names in parts.items():
        if names:
            worst = max(names, key=errs.get)
            out[part] = {"max": errs[worst], "worst": worst,
                         "median": float(np.median([errs[n] for n in names])), "n": len(names)}
    return out


def _agreement(run, ref):
    return {"ball_queries": run["tape"].differ,
            "max_pools": [{"shape": list(a.shape), "maxima_from_other_point": int((a != b).sum())}
                          for a, b in zip(run["sources"], ref["sources"])]}


def grad_gap(dev, cfg, batch) -> dict:
    """One step from the same weights, batch and draws (chip_smoke.py's
    card-vs-CPU step) on the CPU and on ``dev`` in float32, and the point
    part again on the CPU in float64 with the float32 run's choices: where
    the card's neighbours and max-pool sources differ from the CPU's, each
    run's gradient errors against the others, the losses and the sampled
    RoIs."""
    weights = build_network(cfg.MODEL, 1, device="cpu", seed=2).state_dict()
    draws = step_roi_draws(cfg.MODEL, batch["points"].shape[0], 0, 666, "cpu")
    cpu = _run(cfg.MODEL, weights, batch, draws, torch.device("cpu"))
    card = _run(cfg.MODEL, weights, batch, draws, dev, cpu["tape"].calls)
    f64 = point_run_float64(cfg.MODEL, weights, batch, cpu["tape"].calls)
    return {
        "card": _agreement(card, cpu), "float64": _agreement(f64, cpu),
        "grad_rel_err": {
            "card_vs_cpu": summarise(grad_errors(card["grads"], cpu["grads"])),
            "cpu_vs_float64": summarise(grad_errors(cpu["grads"], f64["grads"])),
            "card_vs_float64": summarise(grad_errors(card["grads"], f64["grads"]))},
        "card_metrics": card["metrics"], "cpu_metrics": cpu["metrics"],
        "float64_metrics": f64["metrics"],
        "sampled_roi_match": ((card["rois"] - cpu["rois"]).abs().amax(-1) < 1e-2)
        .float().mean().item()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=["diverge", "grad_gap"])
    parser.add_argument("--device", default="cuda", help="diverge only: cuda or cpu")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    root = Path(tempfile.mkdtemp(prefix="train_probe_"))
    try:
        import chip_smoke as cs

        make_train_set(root)
        if args.probe == "diverge":
            diverge(dev, *cs.first_batch(torch, root, dev), cs.OVERFIT_STEPS)
        else:
            emit({"probe": "grad_gap",
                  **grad_gap(dev, *cs.first_batch(torch, root, torch.device("cpu")))})
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
