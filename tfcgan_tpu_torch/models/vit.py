"""Vision Transformer encoder (the STN localizer's backbone), port of
``tfcgan_tpu.models.vit``: conv patch embedding, CLS token, learned positional
embedding, pre-LN transformer blocks, a final LayerNorm; returns every token.

The patch embedding, a conv whose stride is its kernel, runs as one product
of the flattened patches with the flattened kernel: the same sum. The CPU's
bfloat16 conv gets it wrong at 64 or more out-channels with a 16 x 16 or
64 x 64 kernel (relative error about 1, where the float32 sum rounded once
is off by 1e-3), and the localizer's bfloat16 tokens with it.

Flax's defaults are kept: LayerNorm eps 1e-6, the tanh approximation of GELU,
q scaled by 1/sqrt(head_dim). Parameters are float32 and cast to the compute
dtype where they are used. The attention runs over 17 tokens at 256² with
patch 64: plain einsum + softmax, as the JAX package leaves it to XLA.
Parameter names follow the JAX module tree (``block0.attn.query.weight`` <-
``block0/attn/query/kernel``, see ``tfcgan_tpu_torch.bridge``).

On a tensor mesh (``parallel.tensor``) each sharded ``Dense`` and the patch
embedding compute their own out-features and gather them, and the CLS token
and positional embedding are gathered before use. The attention's q/k/v
flax kernels are (dim, heads, head_dim) and their biases (heads, head_dim):
the JAX rule shards both on the head dim, so the port's q/k/v ``Dense``
shard weight and bias where head_dim divides (``tensor_blocks`` = heads).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import draws_on
from tfcgan_tpu_torch.parallel.tensor import column_parallel, full_param

_LN_EPS = 1e-6


@torch.no_grad()
def lecun_normal_(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Flax's default init for every ``Dense`` and ``nn.Conv2d`` in ``module``:
    weights a truncated normal (+-2 sigma) rescaled to std sqrt(1 / fan_in),
    biases zero. Drawn on the CPU from ``generator``."""
    if not draws_on():
        return
    for m in module.modules():
        if isinstance(m, (Dense, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()


class Dense(nn.Module):
    """y = x W^T + b in ``dtype``; W float32 (out, in), torch's layout.
    ``heads`` > 1: the out-features are (heads, head_dim) in flax (an
    attention's q/k/v), whose bias is then a 2-D leaf too."""

    tensor_axis = None

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32,
                 device=None, heads: int = 1):
        super().__init__()
        self.dtype, self.features = dtype, features
        self.tensor_dims = {"weight": 0, **({"bias": 0} if heads > 1 else {})}
        self.tensor_blocks = heads
        self.weight = nn.Parameter(torch.zeros(features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def _linear(self, x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
        return F.linear(x.to(self.dtype), weight.to(self.dtype),
                        None if bias is None else bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tensor_axis is not None:
            return column_parallel(self, x, self._linear)
        return self._linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm(dtype)``: statistics in float32 (the parameters'
    type: float64 parameters take float64 statistics), eps 1e-6, the result
    in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(self.weight.dtype), x.shape[-1:], self.weight, self.bias, _LN_EPS)
        return y.to(self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention (flax ``MultiHeadDotProductAttention``)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        kw = dict(dtype=dtype, device=device)
        self.query, self.key, self.value = (Dense(dim, dim, heads=heads, **kw)
                                            for _ in range(3))
        self.out = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        q = self.query(x).reshape(b, t, self.heads, hd) / math.sqrt(hd)
        k = self.key(x).reshape(b, t, self.heads, hd)
        v = self.value(x).reshape(b, t, self.heads, hd)
        logits = torch.einsum("bthd,bshd->bhts", q, k)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.out(torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, d))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn = Attention(dim, heads, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.mlp1 = Dense(dim, mlp_dim, **kw)
        self.mlp2 = Dense(mlp_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.norm2(x)), approximate="tanh"))


class ViT(nn.Module):
    """(N, H, W, C) NHWC -> (N, num_patches + 1, dim) token embeddings, for the
    one image size given at construction (the positional embedding's length)."""

    def __init__(self, image_size: int, in_channels: int = 6, patch_size: int = 64,
                 dim: int = 768, depth: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.dim = dtype, dim
        self.tensor_dims = {"cls_token": 2, "pos_embed": 2}
        self.tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size,
                                     device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.tokens, dim, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, heads, mlp_dim, dtype=dtype, device=device)
            for _ in range(depth))
        self.norm = LayerNorm(dim, dtype=dtype, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's init: lecun-normal kernels, zero biases and CLS token, unit
        LayerNorm scales, pos_embed ~ normal(0, 0.02)."""
        lecun_normal_(self, generator)
        self.cls_token.zero_()
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=generator) * 0.02)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_embed.stride[0]
        n, h, w, c = x.shape
        h, w = h // p * p, w // p * p  # a VALID conv's whole patches
        # (N, H/p, W/p, C p p): each patch flattened in the conv kernel's order
        patches = (x[:, :h, :w].to(self.dtype).reshape(n, h // p, p, w // p, p, c)
                   .permute(0, 1, 3, 5, 2, 4).reshape(n, h // p, w // p, c * p * p))

        def embed(patches, weight, bias):
            return F.linear(patches, weight.to(self.dtype).reshape(weight.shape[0], -1),
                            None if bias is None else bias.to(self.dtype))

        if getattr(self.patch_embed, "tensor_axis", None) is not None:
            tokens = column_parallel(self.patch_embed, patches, embed)
        else:
            tokens = embed(patches, self.patch_embed.weight, self.patch_embed.bias)
        tokens = tokens.reshape(n, -1, self.dim)
        if tokens.shape[1] + 1 != self.tokens:
            raise ValueError(f"ViT built for {self.tokens - 1} patches got {tokens.shape[1]}: "
                             f"input {tuple(x.shape)}")
        cls = full_param(self, "cls_token").to(self.dtype).expand(n, 1, self.dim)
        tokens = torch.cat([cls, tokens], dim=1) + full_param(self, "pos_embed").to(self.dtype)
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)
