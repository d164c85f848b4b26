"""Conditional DDPM (TFC-Diff), port of ``tfcgan_tpu.models.diffusion``.

``DDPMSchedule`` is diffusers' ``DDPMScheduler(beta_schedule=
"squaredcos_cap_v2")`` (``add_noise`` and the ancestral ``step`` with
``variance_type="fixed_small"``, ``clip_sample=True``); ``CondUNet`` its
``UNet2DModel`` for the reference's config: block_out_channels (32, 64, 64),
one layer a block, attention at the two lower resolutions (7 attention calls a
forward: 3 over HW/4 tokens and 4 over HW/16), GroupNorm(32, eps 1e-5), head_dim
8, silu, time embedding sinusoid(32) -> Linear(32, 128) -> silu -> Linear(128,
128). Activations are NHWC; module names follow the JAX module tree, so
``bridge.cond_unet_from_flax`` maps parameters by name.

``AttentionBlock`` runs its softmax(QK^T)V through
``ops/flashattn.flash_attention``: the hand-written kernels on a CUDA tensor,
the plain version on the CPU. It hands the kernels permuted views of the
``(N, HW, C)`` projections (head h is channels 8h..8h+7) and gets the result
in the same memory order, so no pack or transpose copy is made.

``sample`` is the whole ancestral chain on the device under
``torch.no_grad()``: a Python loop over Python-int timesteps with no host
synchronisation inside.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import TorchConv
from tfcgan_tpu_torch.models.vit import Dense
from tfcgan_tpu_torch.ops.flashattn import flash_attention
from tfcgan_tpu_torch.ops.norm import group_norm


# ------------------------------------------------------------------ schedule
@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """squaredcos_cap_v2 (Nichol & Dhariwal cosine) schedule, diffusers-exact:
    betas built in float64 on the host and cast to float32; alphas_cumprod the
    sequential float32 running product of the float32 (1 - beta), taken on the
    host. XLA's cumprod in the JAX package is a parallel float32 scan: the two
    agree bit for bit over the first 18 entries and within 1.6e-6 relative
    after (T = 500 and 1000). The first entries matter most: there abar is
    within 1e-4 of 1 and ``step`` divides by 1 - abar_t, so one float32 ulp of
    abar is 1e-3 of a coefficient (a float64 product rounded per entry is
    no further from the JAX array at the far end and eight times further here);
    1 / sqrt(abar_t) near t = T - 1 magnifies the difference at the far end."""

    num_timesteps: int = 500
    max_beta: float = 0.999

    def betas(self) -> np.ndarray:
        t = np.arange(self.num_timesteps + 1, dtype=np.float64) / self.num_timesteps
        abar = np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.clip(1.0 - abar[1:] / abar[:-1], 0.0, self.max_beta).astype(np.float32)

    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(np.float32(1.0) - self.betas(), dtype=np.float32)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0); t: (N,) integer timesteps."""
        ab = torch.from_numpy(self.alphas_cumprod()).to(x0.device)[t.long()]
        ab = ab.view(-1, *([1] * (x0.dim() - 1)))
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def step_coefficients(self, t: int) -> tuple[float, float, float, float, float]:
        """Host scalars of the ancestral step at timestep ``t``, in float32
        arithmetic: (sqrt(1 - abar_t), sqrt(abar_t), coef_x0, coef_xt, sigma)."""
        f = np.float32
        betas, ab = self.betas(), self.alphas_cumprod()
        ab_t, beta_t = ab[t], betas[t]
        ab_prev = ab[t - 1] if t > 0 else f(1.0)
        coef_x0 = np.sqrt(ab_prev) * beta_t / (f(1.0) - ab_t)
        coef_xt = np.sqrt(f(1.0) - beta_t) * (f(1.0) - ab_prev) / (f(1.0) - ab_t)
        var = np.maximum(beta_t * (f(1.0) - ab_prev) / (f(1.0) - ab_t), f(1e-20))
        sigma = np.sqrt(var) if t > 0 else f(0.0)
        return tuple(float(v) for v in (np.sqrt(f(1.0) - ab_t), np.sqrt(ab_t), coef_x0, coef_xt,
                                        sigma))

    def step(self, eps_pred: torch.Tensor, t: int, x_t: torch.Tensor, noise: torch.Tensor,
             clip_sample: bool = True) -> torch.Tensor:
        """One ancestral step x_t -> x_{t-1} with the standard-normal ``noise``
        (unused at t = 0, where no noise is added). ``t`` is a Python int."""
        s1m, sab, coef_x0, coef_xt, sigma = self.step_coefficients(t)
        x0 = (x_t - s1m * eps_pred) / sab
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        mean = coef_x0 * x0 + coef_xt * x_t
        return mean + sigma * noise if t > 0 else mean


# ------------------------------------------------------------------- network
def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, downscale_freq_shift=0)``:
    freqs = exp(-ln(1e4) i / half), emb = [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm(nn.Module):
    """Flax ``GroupNorm(num_groups, epsilon, dtype)`` on NHWC: float32
    statistics, the result in ``dtype``."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias, self.eps).to(self.dtype)


def _conv3(in_channels: int, features: int, stride: int = 1, **kw) -> TorchConv:
    return TorchConv(in_channels, features, kernel_size=3, stride=stride,
                     padding=((1, 1), (1, 1)), **kw)


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: GN -> silu -> conv3x3 -> + Linear(silu(temb)) ->
    GN -> silu -> conv3x3; a 1x1 conv shortcut when the channels change."""

    def __init__(self, in_channels: int, feats: int, temb_channels: int, groups: int = 32,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm(in_channels, groups, **kw)
        self.conv1 = _conv3(in_channels, feats, **kw)
        self.time_emb_proj = Dense(temb_channels, feats, **kw)
        self.norm2 = GroupNorm(feats, groups, **kw)
        self.conv2 = _conv3(feats, feats, **kw)
        self.conv_shortcut = None
        if in_channels != feats:
            self.conv_shortcut = TorchConv(in_channels, feats, kernel_size=1,
                                           padding=((0, 0), (0, 0)), **kw)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """diffusers' spatial self-attention: GN -> to_q/k/v Linear over the HW
    tokens, heads of ``head_dim`` channels, float32 softmax, to_out Linear,
    residual add. The attention itself is ``flash_attention``."""

    def __init__(self, channels: int, head_dim: int = 8, groups: int = 32,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if channels % head_dim:
            raise ValueError(f"channels {channels} is not a multiple of head_dim {head_dim}")
        self.head_dim = head_dim
        kw = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm(channels, groups, **kw)
        self.to_q, self.to_k, self.to_v = (Dense(channels, channels, **kw) for _ in range(3))
        self.to_out = Dense(channels, channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, c = x.shape
        heads = c // self.head_dim
        h = self.group_norm(x).reshape(n, hh * ww, c)

        def split(z: torch.Tensor) -> torch.Tensor:
            # (N, HW, C) -> the (N, heads, D, HW) view of the same memory
            return z.view(n, hh * ww, heads, self.head_dim).permute(0, 2, 3, 1)

        out = flash_attention(split(self.to_q(h)), split(self.to_k(h)), split(self.to_v(h)),
                              self.head_dim ** -0.5)
        # back to (N, HW, C): a view when the result has the projections' memory
        # order (the kernels'), a copy after the plain version
        out = self.to_out(out.permute(0, 3, 1, 2).reshape(n, hh * ww, c))
        return out.reshape(n, hh, ww, c) + x


class CondUNet(nn.Module):
    """UNet2DModel-exact denoiser: eps = f(cat(x_noisy, cond), t), NHWC.

    ``attn[i]`` puts attention after each resnet of down block i; the up path
    uses the reversed flags. Skips as in UNet2DModel.forward: conv_in, every
    resnet(+attn) output and every downsampler output are pushed; each up
    resnet pops one and concatenates it on the channels."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 channels: tuple[int, ...] = (32, 64, 64),
                 attn: tuple[bool, ...] = (False, True, True), layers_per_block: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.channels, self.attn, self.layers_per_block = channels, attn, layers_per_block
        self.out_channels, self.dtype = out_channels, dtype
        kw = dict(dtype=dtype, device=device)
        ch0, temb = channels[0], channels[0] * 4
        self.time_mlp1 = Dense(ch0, temb, **kw)
        self.time_mlp2 = Dense(temb, temb, **kw)
        self.conv_in = _conv3(in_channels, ch0, **kw)
        skips, cur = [ch0], ch0
        for i, ch in enumerate(channels):
            for j in range(layers_per_block):
                setattr(self, f"down{i}_res{j}", ResnetBlock2D(cur, ch, temb, **kw))
                if attn[i]:
                    setattr(self, f"down{i}_attn{j}", AttentionBlock(ch, **kw))
                cur = ch
                skips.append(cur)
            if i + 1 < len(channels):
                setattr(self, f"down{i}_downsample", _conv3(cur, ch, stride=2, **kw))
                skips.append(cur)
        self.mid_res0 = ResnetBlock2D(cur, cur, temb, **kw)
        self.mid_attn = AttentionBlock(cur, **kw)
        self.mid_res1 = ResnetBlock2D(cur, cur, temb, **kw)
        rev, rev_attn = tuple(reversed(channels)), tuple(reversed(attn))
        for i, ch in enumerate(rev):
            for j in range(layers_per_block + 1):
                setattr(self, f"up{i}_res{j}", ResnetBlock2D(cur + skips.pop(), ch, temb, **kw))
                if rev_attn[i]:
                    setattr(self, f"up{i}_attn{j}", AttentionBlock(ch, **kw))
                cur = ch
            if i + 1 < len(rev):
                setattr(self, f"up{i}_upsample", _conv3(cur, ch, **kw))
        self.conv_norm_out = GroupNorm(cur, 32, **kw)
        self.conv_out = _conv3(cur, out_channels, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's defaults: LeCun-normal kernels (truncated at 2 sigma, std
        sqrt(1 / fan_in)), zero biases, unit norm scales. Drawn on the CPU from
        ``generator``."""
        for m in self.modules():
            if isinstance(m, (Dense, TorchConv)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, out_channels) noisy, t (N,) integer timesteps, cond
        (N, H, W, Cc) -> eps (N, H, W, out_channels) in the compute dtype."""
        temb = self.time_mlp1(timestep_embedding(t, self.channels[0]))
        temb = self.time_mlp2(F.silu(temb))
        h = self.conv_in(torch.cat([x, cond.to(x.dtype)], dim=-1))
        skips = [h]
        for i in range(len(self.channels)):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down{i}_res{j}")(h, temb)
                if self.attn[i]:
                    h = getattr(self, f"down{i}_attn{j}")(h)
                skips.append(h)
            if i + 1 < len(self.channels):
                h = getattr(self, f"down{i}_downsample")(h)
                skips.append(h)
        h = self.mid_res1(self.mid_attn(self.mid_res0(h, temb)), temb)
        rev_attn = tuple(reversed(self.attn))
        for i in range(len(self.channels)):
            for j in range(self.layers_per_block + 1):
                h = getattr(self, f"up{i}_res{j}")(torch.cat([h, skips.pop()], dim=-1), temb)
                if rev_attn[i]:
                    h = getattr(self, f"up{i}_attn{j}")(h)
            if i + 1 < len(self.channels):
                # Upsample2D: nearest 2x by repeat, then conv3x3
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = getattr(self, f"up{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def sample(unet: CondUNet, schedule: DDPMSchedule, cond: torch.Tensor,
           generator: torch.Generator | None = None, noise: torch.Tensor | None = None
           ) -> torch.Tensor:
    """The full ancestral chain x_T -> x_0 for ``cond`` (N, H, W, Cc), on
    cond's device: (N, H, W, out_channels) float32.

    The draws are standard normals from ``generator`` (on cond's device), or
    ``noise`` of shape (T + 1, N, H, W, out_channels): ``noise[0]`` is x_T and
    ``noise[1 + i]`` the draw of loop step i (timestep T - 1 - i; the last,
    for t = 0, is not used)."""
    n, h, w, _ = cond.shape
    shape = (n, h, w, unet.out_channels)
    steps = schedule.num_timesteps
    if noise is not None and tuple(noise.shape) != (steps + 1, *shape):
        raise ValueError(f"noise must be {(steps + 1, *shape)}, got {tuple(noise.shape)}")

    def draw(i: int) -> torch.Tensor:
        if noise is not None:
            return noise[i].to(cond.device, torch.float32)
        return torch.randn(shape, device=cond.device, generator=generator)

    with torch.no_grad():
        x = draw(0)
        for i in range(steps):
            t = steps - 1 - i
            tb = torch.full((n,), t, dtype=torch.int32, device=cond.device)
            eps = unet(x, tb, cond).float()
            x = schedule.step(eps, t, x, draw(1 + i) if t > 0 else None)
    return x
