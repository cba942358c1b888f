"""Probe the PointRCNN train step at full width: where a diverging run first
goes non-finite, and where one step's gradients on the card part from the
CPU path's.

    python -m modest_tpu_torch.tools.train_probe diverge [--device cpu]
    python -m modest_tpu_torch.tools.train_probe grad_gap
    python -m modest_tpu_torch.tools.train_probe det_gap [--trials 8] [--lr LR]
    python -m modest_tpu_torch.tools.train_probe bn_gap

The first three run from the repository's root on ``chip_smoke.py``'s
synthetic training set (16 Lyft-sized scans, ``tools/synth_kitti.py``), its
first batch at B = 2 × 12288 and the flagship config, and print one JSON line
per result.

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

``det_gap`` trains the flagship as ``chip_smoke.py``'s self-training round 0
does (one epoch of the synthetic set, B = 2, the one-cycle over its 8 steps
peaking at ``--lr``, by default ``chip_smoke.ROUND_LR``) from ``trials``
seeds, and runs each result's eval forward on the first scan on the card and
on the CPU with SCORE_THRESH 0. Per trial it prints the final boxes' 1:1
agreement, ``chip_smoke.forward_chain``'s stage-by-stage comparison and the
verdict of its check, the spread of the point logits and RCNN scores, and
the ambiguous pairs each of the CPU's two NMS meets (``nms_ambiguity``: a
score gap of twice the card-vs-CPU one, an IoU shell of 1e-3).

``bn_gap`` runs KITTI's PointRCNN (3 classes, 16384 points a scan) on the
first scan of ``chip_smoke.py``'s 3-class KITTI set, once with the batch
norms' statistics taken from a train-mode pass over the batch and once with
``chip_smoke.randomise_bn``'s, on the card and on the CPU in float32 and on
the CPU in float64 with the card's choices, and prints per layer how far
each pair parts and each batch norm's conditioning: whether a card-vs-CPU
gap is the card's or the float32 computation's (``bn_gap``).
"""
from __future__ import annotations

import argparse
import contextlib
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


def make_kitti_set(root: Path):
    """chip_smoke.py's 3-class KITTI set (``phase_kitti_dataset``) in ``root``."""
    import chip_smoke as cs
    from ..configs import KITTI_CLASS_NAMES, KITTI_CONFIGS
    from ..data.kitti_dataset import create_kitti_infos
    from ..tools.synth_kitti import make_dataset
    from ..utils.config import Config

    make_dataset(root, n_train=cs.KITTI_SCANS, n_val=0, seed=0, full_density=True,
                 kitti_classes=True)
    create_kitti_infos(Config(KITTI_CONFIGS["second"]).DATA_CONFIG, KITTI_CLASS_NAMES, root,
                       root, if_val=False)


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


def _point_taps(model, points, tape, pinned: bool = False) -> dict:
    """The eval forward of ``model``'s backbone and point head on
    ``points`` under ``tape``: every batch norm's output, every SA and FP
    level's output features, the point logits, residuals and decoded boxes,
    in forward order, on the CPU."""
    taps = {}

    def tap(name):
        def record(module, inputs, output):
            taps[name] = (output[1] if isinstance(output, tuple) else output).detach().cpu()
        return record

    levels = ("backbone_3d.SA_modules", "backbone_3d.FP_modules")
    handles = [m.register_forward_hook(tap(name)) for name, m in model.named_modules()
               if isinstance(m, torch.nn.BatchNorm1d) or name.rsplit(".", 1)[0] in levels]
    model.eval()
    try:
        with torch.inference_mode(), tape, (PinnedIndices() if pinned else contextlib.nullcontext()):
            cls, box = model.point_head(model.backbone_3d(points))
            b, n = points.shape[:2]
            decoded = model.point_coder.decode(
                box.reshape(-1, model.point_coder.code_size), points[..., :3].reshape(-1, 3),
                (cls.argmax(dim=-1) + 1).reshape(-1)).reshape(b, n, 7)
    finally:
        for h in handles:
            h.remove()
    taps.update(point_cls_preds=cls.cpu(), point_box_preds=box.cpu(),
                point_boxes_decoded=decoded.cpu())
    return taps


def _conditioning(bn) -> dict:
    """A batch norm's running statistics: its smallest variance, its largest
    gain |w| / sqrt(var + eps), and its largest |mean| / sqrt(var + eps), the
    factor by which the input's rounding (a share of |x|) grows against the
    output's scale."""
    std = (bn.running_var.detach().double() + bn.eps).sqrt()
    return {"min_var": float(bn.running_var.min()),
            "max_gain": float((bn.weight.detach().double().abs() / std).max()),
            "max_mean_over_std": float((bn.running_mean.double().abs() / std).max())}


def bn_gap(dev, model_cfg, num_class: int, batch, stats: str) -> dict:
    """PointRCNN's backbone and point head on the first scan of ``batch``,
    with the batch norms' running statistics set by one of
    ``chip_smoke.py``'s two rules (``stats``: "calibrated", from one
    train-mode pass over ``batch`` (``calibrate_grid_model``), or
    "randomised" (``randomise_bn``)), on ``dev`` and on the CPU in float32
    and on the CPU in float64, all with ``dev``'s choices (its ball queries
    replayed; FPS and three-NN pick in float32). Per layer in forward order
    the largest |difference| of each pair and the float64 output's largest
    |value|, with each batch norm's conditioning (``_conditioning``); for
    the point logits and decoded boxes also ``chip_smoke.forward_chain``'s
    ``point_tol_used`` of each pair and the headings that part by more than
    pi (a wrap at +-pi)."""
    import chip_smoke as cs

    model = build_network(model_cfg, num_class, device=dev, seed=0)
    if stats == "calibrated":
        cs.calibrate_grid_model(torch, api, model, model_cfg, batch)
    elif stats == "randomised":
        cs.randomise_bn(torch, model, seed=0)
    else:
        raise ValueError(f"bn_gap: stats {stats!r} is neither calibrated nor randomised")
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    scan = batch["points"][:1]
    card_tape = BallQueryTape()
    card = _point_taps(model, scan.to(dev), card_tape)
    cpu_model = build_network(model_cfg, num_class, device="cpu", seed=0)
    cpu_model.load_state_dict(weights)
    cpu_tape = BallQueryTape(card_tape.calls, substitute=True)
    cpu = _point_taps(cpu_model, scan.cpu(), cpu_tape)
    f64_model = build_network(model_cfg, num_class, device="cpu", seed=0)
    f64_model.load_state_dict(weights)
    f64 = _point_taps(f64_model.double(), scan.cpu().double(),
                      BallQueryTape(card_tape.calls, substitute=True), pinned=True)
    modules = dict(model.named_modules())

    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    layers = []
    for name, ref in f64.items():
        row = {"layer": name, "ref_absmax": float(ref.abs().max()),
               "card_vs_cpu": gap(card[name], cpu[name]),
               "card_vs_float64": gap(card[name], ref), "cpu_vs_float64": gap(cpu[name], ref)}
        if isinstance(modules.get(name), torch.nn.BatchNorm1d):
            row.update(_conditioning(modules[name]))
        layers.append(row)

    def tol_used(got, want):
        return max(float(((got[k].double() - want[k].double()).abs()
                          / (atol + cs.FORWARD_RTOL * want[k].double().abs())).max())
                   for k, atol in (("point_cls_preds", cs.MATCH_SCORE),
                                   ("point_boxes_decoded", cs.MATCH_SIZE)))

    def wraps(got, want):
        return int(((got["point_boxes_decoded"][..., 6].double()
                     - want["point_boxes_decoded"][..., 6].double()).abs() > np.pi).sum())

    pairs = {"card_vs_cpu": (card, cpu), "card_vs_float64": (card, f64),
             "cpu_vs_float64": (cpu, f64)}
    return {"stats": stats, "points": int(scan.shape[1]),
            "ball_queries_differ": sum(q["slots_differ"] for q in cpu_tape.differ),
            "point_tol_used": {k: tol_used(*v) for k, v in pairs.items()},
            "heading_wraps": {k: wraps(*v) for k, v in pairs.items()},
            "layers": layers}


def nms_ambiguity(boxes, scores, thresh: float, max_keep: int, score_gap: float,
                  iou_shell: float) -> dict:
    """The CPU's greedy NMS over ``boxes`` (N, 7) and ``scores`` (N,) and
    the ambiguous pairs it meets: a candidate and an earlier kept box whose
    scores lie within ``score_gap`` and whose IoU exceeds ``thresh`` −
    ``iou_shell`` (the two may go in either order), or whose IoU lies within
    ``iou_shell`` of ``thresh``. Returns the keeps, the keeps before the
    first such pair and the count of pairs."""
    from ..ops.iou3d import boxes_iou_bev

    order = torch.sort(scores, descending=True, stable=True).indices
    order = order[torch.isfinite(scores[order])]
    sb, ss = boxes[order], scores[order]
    kept, first, pairs = [], None, 0
    for t in range(len(order)):
        if len(kept) >= max_keep:
            break
        col = boxes_iou_bev(sb[kept], sb[t:t + 1])[:, 0]
        amb = ((ss[kept] - ss[t]).abs() <= score_gap) & (col > thresh - iou_shell)
        amb |= (col - thresh).abs() <= iou_shell
        pairs += int(amb.sum())
        if first is None and bool(amb.any()):
            first = len(kept)
        if not bool((col > thresh).any()):
            kept.append(t)
    return {"keeps": len(kept), "keeps_before_ambiguity": len(kept) if first is None else first,
            "ambiguous_pairs": pairs}


def det_gap(dev, cfg, trials: int, lr: float) -> list:
    """``trials`` round-0 trainings on ``dev`` and, for each, the card-vs-CPU
    comparison of ``chip_smoke.forward_chain`` on the first scan, its
    verdict, and the ambiguous pairs of the CPU's two NMS (the module
    docstring)."""
    import chip_smoke as cs
    from ..data.loader import batch_to_device, build_dataloader
    from ..train.state import create_train_state, train_step

    cfg.OPTIMIZATION.NUM_EPOCHS = 1
    cfg.OPTIMIZATION.LR = lr
    cfg.DATA_CONFIG.DATA_SPLIT["test"] = "train"
    cfg.DATA_CONFIG.INFO_PATH["test"] = ["kitti_infos_train.pkl"]
    m = cfg.MODEL
    m.POST_PROCESSING.SCORE_THRESH = 0.0
    np.random.seed(666)
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, cs.TRAIN_BATCH, training=True)
    batches = [batch_to_device(b, dev) for b in loader]
    _, test_loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 4, training=False)
    scan = torch.from_numpy(next(iter(test_loader))["points"][:1])
    prop_nms, post_nms = m.ROI_HEAD.NMS_CONFIG.TEST, m.POST_PROCESSING.NMS_CONFIG
    rows = []
    for trial in range(trials):
        model = build_network(m, 1, device=dev, seed=trial)
        state = create_train_state(model, cfg.OPTIMIZATION, len(batches), len(batches))
        for b in batches:
            train_step(state, m, b["points"], b["gt_boxes"])
        cpu_model = build_network(m, 1, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        chain, got, want = cs.forward_chain(torch, np, model, cpu_model, m, scan)
        match = cs.match_finals(np, got, want)
        try:
            cs.check_chain(chain, match["match_frac"],
                           match["card_detections"] + match["cpu_detections"], "det_gap")
            verdict = "pass"
        except SystemExit:
            verdict = "fail"
        cpu = api.apply_eval(cpu_model, m, scan)
        card = api.apply_eval(model, m, scan.to(dev))
        logits = cpu["point_cls_preds"][0].amax(-1)
        logit_gap = float((card["point_cls_preds"].cpu() - cpu["point_cls_preds"]).abs().max())
        top = torch.sort(logits, descending=True, stable=True).indices[
            :int(prop_nms.NMS_PRE_MAXSIZE)]
        rcnn = torch.sigmoid(cpu["batch_cls_preds"][0].amax(-1))
        rcnn_gap = float((torch.sigmoid(card["batch_cls_preds"].cpu())
                          - torch.sigmoid(cpu["batch_cls_preds"])).abs().max())
        rows.append({
            "trial": trial, "final": match, "chain": chain, "verdict": verdict,
            "point_logit_range": [float(logits.min()), float(logits.max())],
            "rcnn_score_range": [float(rcnn.min()), float(rcnn.max())],
            "proposal_nms_cpu": nms_ambiguity(
                cpu["point_boxes_decoded"][0][top], logits[top], float(prop_nms.NMS_THRESH),
                int(prop_nms.NMS_POST_MAXSIZE), 2 * logit_gap, 1e-3),
            "final_nms_cpu": nms_ambiguity(
                cpu["batch_box_preds"][0], torch.where(cpu["roi_valid"][0], rcnn, -float("inf")),
                float(post_nms.NMS_THRESH), int(post_nms.NMS_POST_MAXSIZE), 2 * rcnn_gap, 1e-3)})
        emit({"probe": "det_gap", **rows[-1]})
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=["diverge", "grad_gap", "det_gap", "bn_gap"])
    parser.add_argument("--trials", type=int, default=8, help="det_gap only")
    parser.add_argument("--lr", type=float, default=None,
                        help="det_gap only: the one-cycle's peak (chip_smoke.ROUND_LR)")
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

        if args.probe == "bn_gap":
            make_kitti_set(root)
            cfg = cs.kitti_config("pointrcnn", root)
            _, batch = cs.grid_batch(torch, cfg, dev)
            for stats in ("calibrated", "randomised"):
                emit({"probe": "bn_gap", **bn_gap(dev, cfg.MODEL, len(cfg.CLASS_NAMES), batch,
                                                  stats)})
            return
        make_train_set(root)
        if args.probe == "diverge":
            diverge(dev, *cs.first_batch(torch, root, dev), cs.OVERFIT_STEPS)
        elif args.probe == "det_gap":
            from ..configs import POINTRCNN_DYNAMIC_OBJ_FULL
            from ..utils.config import Config

            cfg = Config(POINTRCNN_DYNAMIC_OBJ_FULL)
            cfg.DATA_CONFIG.DATA_PATH = str(root)
            det_gap(dev, cfg, args.trials, cs.ROUND_LR if args.lr is None else args.lr)
        else:
            emit({"probe": "grad_gap",
                  **grad_gap(dev, *cs.first_batch(torch, root, torch.device("cpu")))})
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
