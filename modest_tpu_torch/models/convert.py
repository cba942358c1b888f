"""Carry weights from the JAX package's PointRCNN into the port.

``state_dict_from_jax(params, batch_stats)`` takes the flax param and
batch-stat trees (nested mappings of arrays) and returns the port's
``state_dict``. The port's keys are pcdet's keys, so the layout rules are
those of a pcdet checkpoint:

- a flax ``Dense`` kernel is (in, out); ``nn.Linear.weight`` is (out, in);
- flax ``BatchNorm`` (scale, bias) + stats (mean, var) → ``BatchNorm1d``
  (weight, bias, running_mean, running_var);
- a ``SharedMLP`` with batch norm is laid out (Linear, BN, ReLU) per layer,
  without it (Linear, ReLU); an ``FCHead``'s last ``Dense`` follows its stack;
- FP modules run deepest first in JAX: ``FPModule_i`` ≡ ``FP_modules.{n-1-i}``.
"""
from __future__ import annotations

import collections.abc
import re

import numpy as np
import torch


def _plain(tree):
    if isinstance(tree, collections.abc.Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def _numbered(tree, stem):
    """Sorted indices i of the ``{stem}_{i}`` children of ``tree``."""
    return sorted(int(m.group(1)) for k in tree if (m := re.fullmatch(rf"{stem}_(\d+)", k)))


def mlp_state_from_jax(params, stats=None, final=None):
    """One flax ``SharedMLP`` subtree (+ its batch stats, + an optional final
    ``Dense`` subtree for an ``FCHead``) → the port's ``SharedMLP``/``FCHead``
    state-dict entries, keyed relative to the module."""
    params, stats = _plain(params), _plain(stats or {})
    dense = _numbered(params, "Dense")
    use_bn = bool(_numbered(params, "BatchNorm"))
    step = 3 if use_bn else 2
    out = {}

    def put_dense(idx, d):
        out[f"{idx}.weight"] = np.ascontiguousarray(d["kernel"].T)
        if "bias" in d:
            out[f"{idx}.bias"] = d["bias"]

    for i in dense:
        put_dense(step * i, params[f"Dense_{i}"])
        if use_bn:
            bn, st = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
            j = step * i + 1
            out.update({f"{j}.weight": bn["scale"], f"{j}.bias": bn["bias"],
                        f"{j}.running_mean": st["mean"], f"{j}.running_var": st["var"],
                        f"{j}.num_batches_tracked": np.zeros((), np.int64)})
    if final is not None:
        put_dense(step * len(dense), _plain(final))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _prefixed(prefix, entries):
    return {f"{prefix}.{k}": v for k, v in entries.items()}


def _fc_state(head, head_stats, name):
    return mlp_state_from_jax(head[name]["SharedMLP_0"],
                              head_stats.get(name, {}).get("SharedMLP_0"),
                              final=head[name]["Dense_0"])


def backbone_state_from_jax(params, stats):
    """flax ``PointNet2MSG`` subtree → the port's ``PointNet2MSG`` entries."""
    P, S = _plain(params), _plain(stats or {})
    sd = {}
    for i in _numbered(P, "SAModuleMSG"):
        sa, sas = P[f"SAModuleMSG_{i}"], S.get(f"SAModuleMSG_{i}", {})
        for j in _numbered(sa, "SharedMLP"):
            entries = mlp_state_from_jax(sa[f"SharedMLP_{j}"], sas.get(f"SharedMLP_{j}"))
            sd.update(_prefixed(f"SA_modules.{i}.mlps.{j}", entries))
    fp = _numbered(P, "FPModule")
    for i in fp:
        sd.update(_prefixed(f"FP_modules.{len(fp) - 1 - i}.mlp", mlp_state_from_jax(
            P[f"FPModule_{i}"]["SharedMLP_0"], S.get(f"FPModule_{i}", {}).get("SharedMLP_0"))))
    return sd


def point_head_state_from_jax(params, stats):
    """flax ``PointHeadBox`` subtree → the port's ``PointHeadBox`` entries."""
    P, S = _plain(params), _plain(stats or {})
    return {**_prefixed("cls_layers", _fc_state(P, S, "FCHead_0")),
            **_prefixed("box_layers", _fc_state(P, S, "FCHead_1"))}


def roi_head_state_from_jax(params, stats):
    """flax ``PointRCNNHead`` subtree → the port's ``PointRCNNHead`` entries."""
    P, S = _plain(params), _plain(stats or {})
    sd = {**_prefixed("xyz_up_layer", mlp_state_from_jax(P["SharedMLP_0"], S.get("SharedMLP_0"))),
          **_prefixed("merge_down_layer",
                      mlp_state_from_jax(P["SharedMLP_1"], S.get("SharedMLP_1")))}
    for i in _numbered(P, "SAModule"):
        sd.update(_prefixed(f"SA_modules.{i}.mlps.0", mlp_state_from_jax(
            P[f"SAModule_{i}"]["SharedMLP_0"], S.get(f"SAModule_{i}", {}).get("SharedMLP_0"))))
    sd.update(_prefixed("cls_layers", _fc_state(P, S, "FCHead_0")))
    sd.update(_prefixed("reg_layers", _fc_state(P, S, "FCHead_1")))
    return sd


def state_dict_from_jax(params, batch_stats):
    """JAX PointRCNN (params, batch_stats) → the port's ``state_dict``."""
    P, S = _plain(params), _plain(batch_stats)
    return {
        **_prefixed("backbone_3d", backbone_state_from_jax(P["backbone"], S.get("backbone"))),
        **_prefixed("point_head", point_head_state_from_jax(P["point_head"], S.get("point_head"))),
        **_prefixed("roi_head", roi_head_state_from_jax(P["roi_head"], S.get("roi_head"))),
    }
