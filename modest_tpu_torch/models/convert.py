"""Carry weights into the port: from the JAX package's detectors, and from
pcdet checkpoints.

``state_dict_from_jax(params, batch_stats)`` (PointRCNN),
``grid_state_dict_from_jax(params, batch_stats, model_cfg)`` (PointPillar,
SECONDNet), ``pvrcnn_state_dict_from_jax``, ``second_iou_state_dict_from_jax``,
``voxelrcnn_state_dict_from_jax`` and ``parta2_state_dict_from_jax`` (same
arguments; the JAX package has no pcdet route for these, nor has the port) take
the flax param and batch-stat trees (nested mappings of arrays) and return
the port's ``state_dict``. ``state_dict_from_pcdet``
brings a pcdet ``model_state`` to the port's layouts. The port's keys are
pcdet's keys, so the layout rules are those of a pcdet checkpoint:

- a flax ``Dense`` kernel is (in, out); ``nn.Linear.weight`` is (out, in);
- flax ``BatchNorm`` (scale, bias) + stats (mean, var) → ``BatchNorm1d``
  (weight, bias, running_mean, running_var);
- a ``SharedMLP`` with batch norm is laid out (Linear, BN, ReLU) per layer,
  without it (Linear, ReLU); an ``FCHead``'s last ``Dense`` follows its stack;
- FP modules run deepest first in JAX: ``FPModule_i`` ≡ ``FP_modules.{n-1-i}``;
- a flax ``Conv`` kernel is (kh, kw, in, out), ``nn.Conv2d.weight`` (out, in,
  kh, kw); a flax ``ConvTranspose`` kernel (kh, kw, in, out) becomes
  ``nn.ConvTranspose2d.weight`` (in, out, kh, kw) flipped in space, since
  flax's transposed conv does not flip its kernel and torch's does;
- a flax ``Conv`` 3-D kernel (kd, kh, kw, in, out) is ``nn.Conv3d.weight``
  (out, in, kd, kh, kw);
- a flax sparse kernel (kvol·in, out) is the port's (kz, ky, kx, in, out),
  spconv 1.x's layout; spconv 2.x stores (out, kz, ky, kx, in);
- SECOND's dense BEV map orders its channels z·C + c, as the JAX package's
  ``_height_compress`` does; pcdet's HeightCompression (``view(N, C·D, H,
  W)``) orders them c·D + z, so a pcdet checkpoint's first BEV conv has its
  input channels permuted on the way in.
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


def _bn_entries(prefix, bn, st):
    return {f"{prefix}.weight": bn["scale"], f"{prefix}.bias": bn["bias"],
            f"{prefix}.running_mean": st["mean"], f"{prefix}.running_var": st["var"],
            f"{prefix}.num_batches_tracked": np.zeros((), np.int64)}


def _conv2d(kernel):
    return np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))


def _conv_transpose2d(kernel):
    return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))


def _bev_state_from_jax(P, S, bb_cfg):
    """flax ``BEVBackbone`` → ``backbone_2d.{blocks,deblocks}``. flax numbers
    its Conv, ConvTranspose and BatchNorm modules each in creation order:
    per level 1 + LAYER_NUMS[i] (conv, BN), then the deblock and its BN."""
    sd = {}
    ci = ti = bi = 0
    for i, n_layers in enumerate(bb_cfg.LAYER_NUMS):
        for j in range(1 + int(n_layers)):
            sd[f"blocks.{i}.{1 + 3 * j}.weight"] = _conv2d(P[f"Conv_{ci}"]["kernel"])
            sd.update(_bn_entries(f"blocks.{i}.{2 + 3 * j}", P[f"BatchNorm_{bi}"],
                                  S[f"BatchNorm_{bi}"]))
            ci, bi = ci + 1, bi + 1
        if float(bb_cfg.UPSAMPLE_STRIDES[i]) >= 1:
            sd[f"deblocks.{i}.0.weight"] = _conv_transpose2d(P[f"ConvTranspose_{ti}"]["kernel"])
            ti += 1
        else:
            sd[f"deblocks.{i}.0.weight"] = _conv2d(P[f"Conv_{ci}"]["kernel"])
            ci += 1
        sd.update(_bn_entries(f"deblocks.{i}.1", P[f"BatchNorm_{bi}"], S[f"BatchNorm_{bi}"]))
        bi += 1
    return sd


def _sparse_state_from_jax(P, S):
    """flax ``VoxelBackBone8x`` → ``backbone_3d.*``: every kernel is 3 × 3 × 3
    but ``conv_out``'s, which is 3 × 1 × 1."""
    sd = {}

    def put(prefix, kernel, bn, st):
        window = (3, 1, 1) if prefix == "conv_out" else (3, 3, 3)
        cin = kernel.shape[0] // (window[0] * window[1] * window[2])
        sd[f"{prefix}.0.weight"] = kernel.reshape(*window, cin, kernel.shape[1])
        sd.update(_bn_entries(f"{prefix}.1", bn, st))

    def block(prefix, name):
        put(prefix, P[name]["SubMConv3d_0"]["kernel"], P[name]["MaskedBatchNorm_0"],
            S[name]["MaskedBatchNorm_0"])

    block("conv_input", "conv_input")
    block("conv1.0", "conv1")
    for s in (2, 3, 4):
        put(f"conv{s}.0", P[f"conv{s}_down"]["kernel"], P[f"conv{s}_down_bn"],
            S[f"conv{s}_down_bn"])
        block(f"conv{s}.1", f"conv{s}_a")
        block(f"conv{s}.2", f"conv{s}_b")
    put("conv_out", P["conv_out"]["kernel"], P["conv_out_bn"], S["conv_out_bn"])
    return sd


def grid_state_dict_from_jax(params, batch_stats, model_cfg):
    """JAX ``GridDetector`` (params, batch_stats) → the port's ``state_dict``
    for the single-head PointPillar or SECONDNet of ``model_cfg``."""
    P, S = _plain(params), _plain(batch_stats)
    sd = {}
    for k in _numbered(P.get("vfe", {}), "Dense"):
        vfe, vst = P["vfe"], S["vfe"]
        sd[f"vfe.pfn_layers.{k}.linear.weight"] = np.ascontiguousarray(
            vfe[f"Dense_{k}"]["kernel"].T)
        sd.update(_bn_entries(f"vfe.pfn_layers.{k}.norm", vfe[f"MaskedBatchNorm_{k}"],
                              vst[f"MaskedBatchNorm_{k}"]))
    if "backbone_3d" in P:
        sd.update(_prefixed("backbone_3d", _sparse_state_from_jax(P["backbone_3d"],
                                                                  S["backbone_3d"])))
    sd.update(_prefixed("backbone_2d", _bev_state_from_jax(
        P["backbone_2d"], S["backbone_2d"], model_cfg.BACKBONE_2D)))
    head = P["dense_head"]
    for name, ours in (("conv_cls", "Conv_0"), ("conv_box", "Conv_1"),
                       ("conv_dir_cls", "Conv_2")):
        if ours in head:
            sd[f"dense_head.{name}.weight"] = _conv2d(head[ours]["kernel"])
            sd[f"dense_head.{name}.bias"] = head[ours]["bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def pvrcnn_state_dict_from_jax(params, batch_stats, model_cfg):
    """JAX ``PVRCNN`` (params, batch_stats) → the port's ``state_dict``: stage
    1 as SECOND's, each VSA source's and the RoI-grid pool's per-radius
    ``SharedMLP_i`` → ``.i``, the fusion and shared-FC stacks, and the PKW
    and RCNN ``FCHead``s."""
    P, S = _plain(params), _plain(batch_stats)
    sd = dict(grid_state_dict_from_jax(params, batch_stats, model_cfg))

    def sources(jax_name, port_name):
        for i in _numbered(P[jax_name], "SharedMLP"):
            sd.update(_prefixed(f"{port_name}.{i}", mlp_state_from_jax(
                P[jax_name][f"SharedMLP_{i}"], S.get(jax_name, {}).get(f"SharedMLP_{i}"))))

    for name in model_cfg.PFE.FEATURES_SOURCE:
        if name != "bev":
            sources(f"vsa_{name}", f"vsa.{name}")
    sources("roi_grid_pool", "roi_grid_pool")
    for name in ("vsa_fusion", "roi_shared_fc"):
        sd.update(_prefixed(name, mlp_state_from_jax(P[name], S.get(name))))
    for name in ("pkw_head", "rcnn_cls", "rcnn_reg"):
        sd.update(_prefixed(name, _fc_state(P, S, name)))
    return sd


def second_iou_state_dict_from_jax(params, batch_stats, model_cfg):
    """JAX ``SECONDIoU`` (params, batch_stats) → the port's ``state_dict``:
    stage 1 as SECOND's, then ``iou_mlp`` and the ``iou_head`` ``FCHead``."""
    P, S = _plain(params), _plain(batch_stats)
    sd = dict(grid_state_dict_from_jax(params, batch_stats, model_cfg))
    sd.update(_prefixed("iou_mlp", mlp_state_from_jax(P["iou_mlp"], S.get("iou_mlp"))))
    sd.update(_prefixed("iou_head", _fc_state(P, S, "iou_head")))
    return sd


def _rcnn_heads(P, S):
    sd = _prefixed("roi_shared_fc", mlp_state_from_jax(P["roi_shared_fc"], S.get("roi_shared_fc")))
    for name in ("rcnn_cls", "rcnn_reg"):
        sd.update(_prefixed(name, _fc_state(P, S, name)))
    return sd


def voxelrcnn_state_dict_from_jax(params, batch_stats, model_cfg):
    """JAX ``VoxelRCNN`` (params, batch_stats) → the port's ``state_dict``:
    stage 1 as SECOND's, each scale's ``pool_<scale>`` per-radius
    ``SharedMLP_i`` → ``grid_pools.<scale>.i``, and the shared-FC and RCNN
    heads."""
    P, S = _plain(params), _plain(batch_stats)
    sd = dict(grid_state_dict_from_jax(params, batch_stats, model_cfg))
    for name in model_cfg.ROI_HEAD.ROI_GRID_POOL.FEATURES_SOURCE:
        pool, stats = P[f"pool_{name}"], S.get(f"pool_{name}", {})
        for i in _numbered(pool, "SharedMLP"):
            sd.update(_prefixed(f"grid_pools.{name}.{i}", mlp_state_from_jax(
                pool[f"SharedMLP_{i}"], stats.get(f"SharedMLP_{i}"))))
    sd.update(_rcnn_heads(P, S))
    return sd


def unet_state_from_jax(params, stats):
    """flax ``SparseUNet`` → the port's ``SparseUNet`` entries: the encoder as
    ``VoxelBackBone8x``'s, each ``up<k>_inv`` (27, in, out) and
    ``up<k>_merge`` (27·in, out) kernel → ``up<k>.inv`` and ``up<k>.merge``
    (3, 3, 3, in, out), with their batch norms."""
    P, S = _plain(params), _plain(stats)
    sd = _sparse_state_from_jax(P, S)
    for k in (4, 3, 2):
        for part in ("inv", "merge"):
            kernel = P[f"up{k}_{part}"]["kernel"]
            sd[f"up{k}.{part}.0.weight"] = kernel.reshape(3, 3, 3, -1, kernel.shape[-1])
            sd.update(_bn_entries(f"up{k}.{part}.1", P[f"up{k}_{part}_bn"],
                                  S[f"up{k}_{part}_bn"]))
    return sd


def parta2_state_dict_from_jax(params, batch_stats, model_cfg):
    """JAX ``PartA2`` (params, batch_stats) → the port's ``state_dict``:
    stage 1 as SECOND's, the UNet by ``unet_state_from_jax``; the point
    heads, ``pool_proj``; each ``tower_conv<i>`` (3, 3, 3, in, out) kernel →
    ``conv_tower.<i>.conv.weight`` (out, in, 3, 3, 3) and its bias, each
    ``tower_bn<i>`` → ``conv_tower.<i>.bn``; the shared-FC and RCNN heads."""
    P, S = _plain(params), _plain(batch_stats)
    sd = dict(grid_state_dict_from_jax(params, batch_stats, model_cfg))
    sd.update(_prefixed("backbone_3d", unet_state_from_jax(P["backbone_3d"], S["backbone_3d"])))
    for name in ("seg_head", "part_head"):
        sd.update(_prefixed(name, _fc_state(P, S, name)))
    sd.update(_prefixed("pool_proj", mlp_state_from_jax(P["pool_proj"], S.get("pool_proj"))))
    for i in range(len(model_cfg.ROI_HEAD.CONV_TOWER.NUM_FILTERS)):
        conv = P[f"tower_conv{i}"]
        sd[f"conv_tower.{i}.conv.weight"] = np.ascontiguousarray(
            conv["kernel"].transpose(4, 3, 0, 1, 2))
        sd[f"conv_tower.{i}.conv.bias"] = conv["bias"]
        sd.update(_bn_entries(f"conv_tower.{i}.bn", P[f"tower_bn{i}"], S[f"tower_bn{i}"]))
    sd.update(_rcnn_heads(P, S))
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v)) for k, v in sd.items()}


def spconv_layout(model_state) -> str:
    """``"spconv1"`` ((kz, ky, kx, in, out)) or ``"spconv2"`` ((out, kz, ky,
    kx, in)) for a pcdet SECOND ``model_state``, decided from the
    non-square ``conv_input`` (in 4, out 16), as the JAX converter does."""
    w = model_state["backbone_3d.conv_input.0.weight"]
    out = model_state["backbone_3d.conv_input.1.weight"].shape[0]
    if w.shape[-1] == out and w.shape[0] != out:
        return "spconv1"
    if w.shape[0] == out and w.shape[-1] != out:
        return "spconv2"
    raise ValueError(f"cannot tell the spconv layout of conv_input {tuple(w.shape)}")


def state_dict_from_pcdet(model_state, model):
    """A pcdet ``model_state`` in the port's layouts for ``model``. Only a
    SECONDNet needs changes: spconv 2.x sparse weights go to 1.x's layout,
    and the first BEV conv's input channels go from pcdet's c·D + z to the
    port's z·C + c (D height slices of C channels). Other models and keys
    pass as they are."""
    out = dict(model_state)
    if getattr(model, "model_cfg", {}).get("NAME", "") != "SECONDNet":
        return out
    if "backbone_3d.conv_input.0.weight" in model_state \
            and spconv_layout(model_state) == "spconv2":
        for k, w in model_state.items():
            if k.startswith("backbone_3d.") and w.dim() == 5:
                out[k] = w.permute(1, 2, 3, 4, 0).contiguous()
    key = "backbone_2d.blocks.0.1.weight"
    if key in model_state:
        c = model.backbone_3d.conv_out[0].weight.shape[-1]
        w = model_state[key]
        d = w.shape[1] // c
        # port channel z·C + c reads pcdet channel c·D + z
        out[key] = w.reshape(w.shape[0], c, d, *w.shape[2:]).transpose(1, 2).reshape(w.shape)
    return out
