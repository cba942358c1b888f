"""DeepLabV3 depth-distribution network of CaDDN — port of
``modest_tpu/models/ddn_deeplabv3.py`` (reference pcdet
backbones_3d/vfe/image_vfe_modules/ffn/ddn/ddn_deeplabv3.py, which wraps
torchvision's ``deeplabv3_resnet101``).

The modules carry torchvision's ``deeplabv3_resnet*`` names
(``backbone.conv1``, ``backbone.layer1.0.conv1`` … ``downsample.{0,1}``,
``classifier.0.convs.{0..4}``, ``classifier.0.project``,
``classifier.{1,2,4}``), so a torchvision state loads as it is and a pcdet
CaDDN state after its ``vfe.ffn.ddn.model.`` prefix is taken off
(``models/convert.py::caddn_state_dict_from_pcdet``).

As in JAX: a ResNet-50 or -101 v1 backbone with torchvision's
``replace_stride_with_dilation=[False, True, True]`` (strides 1/2/1/1,
dilations 1/1/2/4, the first block of layer3 and layer4 at the previous
dilation), features taken at ``layer1`` (256 channels, stride 4), the
DeepLab head (ASPP at rates 12/24/36 and an image-pooling branch, a 3 × 3
conv, a 1 × 1 classifier) and its logits resized bilinearly
(``align_corners=False``, ``jax.image.resize``'s "linear") to the features'
map. The batch norms train as flax's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)``. The ASPP's dropout keeps each value with probability 1/2;
its keep mask can be handed in (a JAX train step's, for a test) or drawn from
a ``torch.Generator``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.mesh import global_batch, rank_rows
from .layers import BatchNorm2d

RESNET_BLOCKS = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3)}
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
DROPOUT = 0.5


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, dilation: int = 1, bias=False):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck (torchvision's layout: conv1/bn1 … downsample)."""

    def __init__(self, c_in: int, width: int, stride: int = 1, dilation: int = 1,
                 has_down: bool = False):
        super().__init__()
        self.conv1 = _conv(c_in, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride, dilation)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = _bn(width * 4)
        self.downsample = (nn.Sequential(_conv(c_in, width * 4, 1, stride), _bn(width * 4))
                           if has_down else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetBackbone(nn.Module):
    """The stem (7 × 7 / 2 conv, 3 × 3 / 2 max pool) and the four layers;
    ``forward`` returns (layer1's map, layer4's map)."""

    def __init__(self, blocks):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        c_in = 64
        for li, (n_blocks, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
            d0 = DILATIONS[li - 1] if li > 0 else 1  # torchvision's first block
            layer = []
            for bi in range(n_blocks):
                layer.append(Bottleneck(c_in, width, STRIDES[li] if bi == 0 else 1,
                                        d0 if bi == 0 else DILATIONS[li], has_down=bi == 0))
                c_in = width * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x):
        y = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        feats = self.layer1(y)
        return feats, self.layer4(self.layer3(self.layer2(feats)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (torchvision's ASPP): a 1 × 1 branch,
    3 × 3 branches at ``rates``, an image-pooling branch (global mean, 1 × 1
    conv, broadcast back), the 1 × 1 projection and dropout."""

    def __init__(self, c_in: int = 2048, channels: int = 256, rates=(12, 24, 36)):
        super().__init__()
        convs = [nn.Sequential(_conv(c_in, channels, 1), _bn(channels), nn.ReLU())]
        for r in rates:
            convs.append(nn.Sequential(_conv(c_in, channels, 3, dilation=r), _bn(channels),
                                       nn.ReLU()))
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1), _conv(c_in, channels, 1),
                                   _bn(channels), nn.ReLU()))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(_conv(len(convs) * channels, channels, 1), _bn(channels),
                                     nn.ReLU(), nn.Dropout(DROPOUT))

    def forward(self, x, dropout=None):
        """``dropout`` (train mode): a bool keep mask of the output's shape,
        or a ``torch.Generator`` to draw it from (the global one when None)
        for the global batch's rows."""
        outs = [conv(x) for conv in self.convs]
        outs[-1] = outs[-1].expand_as(outs[0])  # a 1 × 1 map's bilinear resize is a broadcast
        conv, bn, relu, _ = self.project
        y = relu(bn(conv(torch.cat(outs, dim=1))))
        if not self.training:
            return y
        if not isinstance(dropout, torch.Tensor):
            # drawn for the global batch, as JAX's sharded step draws it; this
            # process keeps its rows
            b = y.shape[0]
            u = torch.rand((global_batch(b), *y.shape[1:]), generator=dropout, device=y.device)
            dropout = rank_rows(u, b) >= DROPOUT
        return torch.where(dropout, y / (1.0 - DROPOUT), 0.0)


class DDNDeepLabV3(nn.Module):
    """``forward(x (B, 3, H, W))`` → (features (B, 256, H/4, W/4), logits
    (B, num_classes, H/4, W/4)). ``dropout`` goes to the ASPP;
    ``on_stage(name)``, when given, is called after the backbone
    ("ddn_backbone") and after the ASPP ("ddn_aspp")."""

    def __init__(self, num_classes: int, backbone_name: str = "ResNet101"):
        super().__init__()
        self.backbone = ResNetBackbone(RESNET_BLOCKS[backbone_name])
        self.classifier = nn.Sequential(ASPP(), _conv(256, 256, 3), _bn(256), nn.ReLU(),
                                        _conv(256, num_classes, 1, bias=True))

    def forward(self, x, dropout=None, on_stage=None):
        mark = on_stage or (lambda name: None)
        feats, y = self.backbone(x)
        mark("ddn_backbone")
        y = self.classifier[0](y, dropout)
        mark("ddn_aspp")
        for layer in self.classifier[1:]:
            y = layer(y)
        logits = F.interpolate(y, size=feats.shape[-2:], mode="bilinear", align_corners=False)
        return feats, logits
