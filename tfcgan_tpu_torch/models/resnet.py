"""ResNet-18 classifier, port of ``tfcgan_tpu.models.resnet``: the regional
ethnicity CNNs of the debiased family (V4-V7), on hair and eye bands.

Two norm forms, as in the JAX module: ``"gn"``, a GroupNorm with one
channel a group (flax's arithmetic, eps 1e-6) after every conv, which has
no bias; ``"folded"``, biased convs and no norm, the form of torchvision
weights with their eval-mode BatchNorm folded in. Stem conv 7x7 stride 2,
max-pool 3x3 stride 2 over -inf padding, four stages of two ``BasicBlock``s
(64, 128, 256, 512; stride 2 from the second stage, a 1x1 conv shortcut
where the shape changes), global average pool, then the classifier ``fc``.
The classifier's Dropout(0.3) runs deterministic: the recipe applies these
networks as the JAX recipe does, in eval mode. Parameter names follow the
flax tree (``layer1_0.conv1.weight`` <- ``layer1_0/conv1/kernel``, a norm's
``scale`` -> ``weight``), so ``bridge.conv_net_from_flax`` converts them.

No converted torchvision weights are in the repository; where the JAX
package loads them (``resolve_resnet_weights``: the file
``tools/convert_resnet.py`` writes), the recipe builds the ``folded`` form
and loads the backbone through ``load_resnet18_backbone``.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import GroupNorm, TorchConv, draws_on
from tfcgan_tpu_torch.models.vit import Dense
from tfcgan_tpu_torch.parallel.spatial import Rows

_WEIGHTS_ENV = "TFCGAN_RESNET_WEIGHTS"
_WEIGHTS_NAME = "resnet18_flax.msgpack"
STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def resolve_resnet_weights(loss_cfg) -> str:
    """``LossConfig.resnet_weights`` if set, else ``$TFCGAN_RESNET_WEIGHTS``,
    else ``weights/resnet18_flax.msgpack`` beside the package if it exists,
    else "" (the JAX package's lookup)."""
    explicit = getattr(loss_cfg, "resnet_weights", "") or os.environ.get(_WEIGHTS_ENV, "")
    if explicit:
        return explicit
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(here, "weights", _WEIGHTS_NAME)
    return cand if os.path.exists(cand) else ""


def _conv(cin: int, feats: int, k: int, stride: int, bias: bool, **kw) -> TorchConv:
    pad = (k // 2, k // 2)
    return TorchConv(cin, feats, kernel_size=k, stride=stride, padding=(pad, pad),
                     use_bias=bias, **kw)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Flax's init for every conv, Dense and GroupNorm in ``module``, drawn on
    the CPU from ``generator``: lecun-normal conv and Dense kernels (a
    truncated normal, +-2 sigma, rescaled to std sqrt(1 / fan_in)), zero
    biases, norm scales one."""
    if not draws_on():
        return
    for m in module.modules():
        if isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, (TorchConv, Dense)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            m.weight.copy_(w)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


class BasicBlock(nn.Module):
    """conv3x3(stride) -> [norm] -> relu -> conv3x3 -> [norm], plus the input
    (through a 1x1 conv(stride) -> [norm] where the shape changes), relu."""

    def __init__(self, in_channels: int, feats: int, stride: int = 1, norm: str = "gn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if norm not in ("gn", "folded"):
            raise ValueError(f"norm must be 'gn' or 'folded', got {norm!r}")
        kw = dict(dtype=dtype, device=device)
        bias, gn = norm == "folded", norm == "gn"
        self.conv1 = _conv(in_channels, feats, 3, stride, bias, **kw)
        self.n1 = GroupNorm(feats, feats, 1e-6, **kw) if gn else None
        self.conv2 = _conv(feats, feats, 3, 1, bias, **kw)
        self.n2 = GroupNorm(feats, feats, 1e-6, **kw) if gn else None
        self.down = self.dn = None
        if stride != 1 or in_channels != feats:
            self.down = _conv(in_channels, feats, 1, stride, bias, **kw)
            self.dn = GroupNorm(feats, feats, 1e-6, **kw) if gn else None

    @staticmethod
    def _norm(norm: GroupNorm | None, x: torch.Tensor, rows: Rows | None = None
              ) -> torch.Tensor:
        return x if norm is None else norm(x, rows)

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        """With ``rows``, this rank's rows of the input and of the output
        (of the height ``out_height`` gives): the convs fetch their halo
        rows and the norms sum over the spatial group."""
        out = rows and rows.of(self.conv1.out_height(rows.h))
        h = F.relu(self._norm(self.n1, self.conv1(x, rows), out))
        h = self._norm(self.n2, self.conv2(h, out), out)
        if self.down is not None:
            x = self._norm(self.dn, self.down(x, rows), out)
        return F.relu(x + h)

    def out_height(self, h: int) -> int:
        return self.conv1.out_height(h)


class ResNet18(nn.Module):
    """(N, H, W, in_channels) NHWC -> (N, num_classes) logits."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 norm: str = "gn", dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.stem = _conv(in_channels, 64, 7, 2, norm == "folded", **kw)
        self.stem_norm = GroupNorm(64, 64, 1e-6, **kw) if norm == "gn" else None
        cin = 64
        for i, (feats, blocks, stride) in enumerate(STAGES):
            for b in range(blocks):
                setattr(self, f"layer{i}_{b}",
                        BasicBlock(cin, feats, stride if b == 0 else 1, norm, **kw))
                cin = feats
        self.fc = Dense(cin, num_classes, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        flax_init_(self, generator)

    def blocks(self) -> list[BasicBlock]:
        return [getattr(self, f"layer{i}_{b}") for i, (_, n, _) in enumerate(STAGES)
                for b in range(n)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x.to(self.dtype))
        if self.stem_norm is not None:
            h = self.stem_norm(h)
        h = F.max_pool2d(F.relu(h).permute(0, 3, 1, 2), 3, stride=2, padding=1)
        h = h.permute(0, 2, 3, 1)
        for block in self.blocks():
            h = block(h)
        return self.fc(h.mean(dim=(1, 2)))


def load_resnet18_backbone(path: str) -> dict[str, torch.Tensor]:
    """The backbone of ``ResNet18(norm="folded")`` from a converted flax file
    (the JAX ``load_resnet18_backbone``): every parameter but the classifier
    ``fc``, which is trained fresh, validated against the module's structure:
    a missing, extra or misshaped leaf raises ``ValueError``."""
    from tfcgan_tpu_torch.bridge import resnet18_from_flax
    from tfcgan_tpu_torch.models.layers import without_draws
    from tfcgan_tpu_torch.weights_msgpack import check_state_dict, read_flax_msgpack

    tree = read_flax_msgpack(path)
    try:
        state = resnet18_from_flax(tree.get("params", tree))
    except KeyError as e:
        raise ValueError(f"{path}: {e.args[0]}") from None
    with without_draws():
        template = ResNet18(1, norm="folded", device="meta").state_dict()
    template = {k: v for k, v in template.items() if not k.startswith("fc.")}
    return check_state_dict(state, template, path)
