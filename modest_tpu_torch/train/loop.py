"""Epoch-level training and eval loops — port of ``modest_tpu/train/loop.py``
(reference tools/train_utils/train_utils.py, tools/eval_utils/eval_utils.py).

Each step's metrics are read back to the host once per step (one
synchronisation), so every step's loss is logged and checked; with
``stage_times`` each step also records CUDA-event times of its stages. The
eval loop reads each batch's final boxes and its recall counts back once.
One process on one device: the JAX loop's multi-process merge of results
is not ported.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import torch

from ..data.loader import prefetch_to_device
from ..models import api as model_api
from ..ops.iou3d import boxes_iou3d
from .state import train_step


class _StageEvents:
    """CUDA events at the boundaries of one step's stages."""

    def __init__(self):
        self.events = []

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def ms(self) -> dict:
        """Milliseconds per stage; call after the step's work has finished."""
        pairs = zip(self.events, self.events[1:])
        return {name: a.elapsed_time(b) for (_, a), (name, b) in pairs}


def train_model(state, model_cfg, loader, *, device, start_epoch: int, total_epochs: int,
                ckpt_manager=None, ckpt_save_interval: int = 1, logger=None,
                seed: int = 666, log_interval: int = 50,
                merge_all_iters_to_one_epoch: bool = False, metrics_logger=None,
                stage_times: bool = False):
    """Train ``state`` from ``start_epoch`` to ``total_epochs``, saving a
    checkpoint after every ``ckpt_save_interval``-th epoch. Returns one
    record per step: epoch, step, metrics (floats), ``data_wait_ms`` (host
    time waiting for the batch), ``end_s`` (host clock after the step's
    metrics were read) and, with ``stage_times`` on a CUDA device,
    ``stage_ms`` by CUDA events (the model's forward stages, then loss,
    backward and optimizer)."""
    log = logger.info if logger else print
    timed = stage_times and torch.device(device).type == "cuda"
    history = []

    def run_epoch(epoch, batches, its_this_epoch):
        t0 = time.perf_counter()
        metrics = {}
        for n_it in range(1, its_this_epoch + 1):
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            data_wait_ms = (time.perf_counter() - t_wait) * 1e3
            events = _StageEvents() if timed else None
            if events:
                events.mark("start")
            step, lr = state.step, state.optimizer.current_lr()
            out = train_step(state, model_cfg, batch["points"], batch["gt_boxes"], seed=seed,
                             on_stage=events.mark if events else None)
            keys = list(out)
            metrics = dict(zip(keys, torch.stack([out[k].float() for k in keys]).tolist()))
            rec = {"epoch": epoch, "step": step, "metrics": metrics,
                   "data_wait_ms": data_wait_ms, "end_s": time.perf_counter()}
            if events:
                rec["stage_ms"] = events.ms()
            history.append(rec)
            if metrics_logger is not None:
                metrics_logger.log(step, {**metrics, "lr": lr}, prefix="train/")
            if n_it % log_interval == 0:
                log(f"epoch {epoch} it {n_it}/{its_this_epoch} loss {metrics['loss']:.4f} "
                    f"lr {lr:.6f}")
        log(f"epoch {epoch} done in {time.perf_counter() - t0:.1f}s "
            + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if ckpt_manager is not None and (epoch + 1) % ckpt_save_interval == 0:
            ckpt_manager.save(state, epoch + 1)

    if merge_all_iters_to_one_epoch:
        # the merged dataset holds total_epochs × N samples: one pass over
        # the loader is the whole run, checkpointed every len/total_epochs
        # steps (reference train_utils.train_model)
        its_per_epoch = max(len(loader) // max(total_epochs, 1), 1)
        loader.set_epoch(0)
        batches = prefetch_to_device(loader, device)
        for _ in range(start_epoch * its_per_epoch):  # resume: skip what was consumed
            next(batches, None)
        for epoch in range(start_epoch, total_epochs):
            run_epoch(epoch, batches, its_per_epoch)
    else:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            run_epoch(epoch, prefetch_to_device(loader, device), len(loader))
    return history


def _trim_predictions(final):
    """Padded final boxes (tensors) → per-sample numpy pred dicts of the
    valid rows."""
    boxes, scores, labels, valid = (final[k].cpu().numpy()
                                    for k in ("boxes", "scores", "labels", "valid"))
    return [{"pred_boxes": boxes[i][valid[i]], "pred_scores": scores[i][valid[i]],
             "pred_labels": labels[i][valid[i]].astype(int)} for i in range(len(boxes))]


def _recall_update(recall_dict, final, gt_boxes, thresh_list):
    """Add one batch's roi/rcnn recall counts against its gt boxes
    (reference detector3d_template:283-325). ``final`` and ``gt_boxes``
    (B, M, 8), zero rows padding, are tensors on one device: the 3D IoUs
    are computed there and the counts read back once."""
    gt = gt_boxes[..., :7].float()
    gt_valid = gt_boxes.abs().sum(-1) > 0  # (B, M)
    counts = [gt_valid.sum()]
    keys = ["gt"]
    cands = [("rcnn", final["boxes"], final["valid"])]
    if final.get("rois") is not None:
        rois = final["rois"]
        cands.append(("roi", rois, torch.ones(rois.shape[:2], dtype=torch.bool,
                                               device=rois.device)))
    for name, cand, cand_valid in cands:
        ious = torch.where(cand_valid[..., None], boxes_iou3d(cand[..., :7].float(), gt), 0.0)
        best = ious.amax(1)  # (B, M): each gt box's best IoU
        for t in thresh_list:
            keys.append(f"{name}_{t}")
            counts.append(((best > t) & gt_valid).sum())
    counts = torch.stack(counts).tolist()
    if counts[0] == 0:  # no gt box in the batch: no key is added, as in JAX
        return recall_dict
    for key, n in zip(keys, counts):
        recall_dict[key] = recall_dict.get(key, 0) + int(n)
    return recall_dict


def eval_one_epoch(model, model_cfg, loader, dataset, class_names, *, device, result_dir=None,
                   logger=None, save_to_file=False):
    """Detect on every sample of ``loader`` (not shuffled; its wrap-padded
    tail batch repeats earlier frames, which add nothing to the annos, the
    recall or the frame count), write ``result_dir/result.pkl`` (the KITTI
    annos, numpy) and evaluate them against the split's labels. Returns
    (det_annos, {"sec_per_example", "steady_sec_per_example", "recall",
    **AP}): ``sec_per_example`` counts from the loop's start, loader start-up
    included; ``steady_sec_per_example`` from the end of the first batch to
    the end of the last, over the frames after the first batch (None with
    one batch)."""
    log = logger.info if logger else print
    det_annos = []
    seen = set()
    recall_dict = {}
    thresh_list = list(model_cfg.POST_PROCESSING.RECALL_THRESH_LIST)
    t0 = time.time()
    t_first, n_first = None, 0
    for batch in prefetch_to_device(loader, device):
        final = model_api.post_process(model_api.apply_eval(model, model_cfg, batch["points"]),
                                       model_cfg)
        fresh = [i for i, fid in enumerate(batch["frame_id"]) if fid not in seen]
        if "gt_boxes" in batch and fresh:
            sub = torch.as_tensor(fresh, device=batch["points"].device)
            recall_dict = _recall_update(
                recall_dict, {k: (v[sub] if v is not None else None) for k, v in final.items()},
                batch["gt_boxes"][sub], thresh_list)
        annos = dataset.generate_prediction_dicts(
            batch, _trim_predictions(final), class_names,
            output_path=result_dir if save_to_file else None)
        for a in annos:
            if a["frame_id"] in seen:  # the wrap-padded tail batch
                continue
            seen.add(a["frame_id"])
            det_annos.append(a)
        if t_first is None:  # the annos are numpy: the batch's work has ended
            t_first, n_first = time.time(), len(det_annos)
    t_end = time.time()
    sec_per_example = (t_end - t0) / max(len(det_annos), 1)
    steady = ((t_end - t_first) / (len(det_annos) - n_first)
              if len(det_annos) > n_first else None)
    log(f"eval: {len(det_annos)} frames, {sec_per_example:.4f} sec_per_example")

    if recall_dict.get("gt", 0) > 0:
        for t in thresh_list:
            for name in ("roi", "rcnn"):
                k = f"{name}_{t}"
                if k in recall_dict:
                    log(f"recall_{k}: {recall_dict[k] / recall_dict['gt']:.4f}")

    if result_dir is not None:
        result_dir = Path(result_dir)
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(det_annos, f)

    ret = {"sec_per_example": sec_per_example, "steady_sec_per_example": steady,
           "recall": recall_dict}
    ap_str, ap_dict = dataset.evaluation(det_annos, class_names)
    if ap_str is not None:
        log(ap_str)
    ret.update(ap_dict or {})
    return det_annos, ret
