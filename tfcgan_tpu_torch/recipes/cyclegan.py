"""The CycleGAN baseline recipe, port of ``tfcgan_tpu.recipes.cyclegan``.

Two ResNet generators (``extra["resnet_blocks"]``, 9 by default), G_AB and
G_BA, and two PatchGAN discriminators, D_A and D_B (``CycleDiscriminator``);
least-squares GAN terms, cycle consistency (lambda_cyc = 10) and identity
(lambda_id = 5):

    loss_G = 0.5 * (GAN(D_B(G_AB(A)), 1) + GAN(D_A(G_BA(B)), 1))
             + lambda_cyc * 0.5 * (L1(G_BA(G_AB(A)), A) + L1(G_AB(G_BA(B)), B))
             + lambda_id * 0.5 * (L1(G_BA(A), A) + L1(G_AB(B), B))

Each discriminator sees the real images and fakes drawn through a 50-image
replay buffer (``replay_push_sample``): the recipe-owned state ``extra``
holds the two buffers and their counts on the device, and the trainer's
``pre_d`` hook pushes the step's detached fakes before the D phase. The D
loss is loss_D_A + loss_D_B, each 0.5 * (real + fake) (the reference's two
Adams over disjoint parameters are one Adam over the sum), reported as
``loss_D`` = half of it. The step's draws, the buffers' coin flips and
slots, are a ``CycleDraws``.

On a spatial mesh (``parallel.spatial``; the step's image rows in
``active_rows()``) the recipe runs on row shards:
G_AB, G_BA, D_A and D_B on this rank's rows, the L1 and GAN terms its shares
of their means. The buffers stay whole on every rank: ``pre_d`` pushes the
step's fakes gathered over the data and the spatial groups, and each rank
keeps its samples' rows of the returned images. So ``initial_extra`` and a
checkpoint's buffers have one shape on every mesh.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn as nn

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.models.discriminator import StridedPatchDiscriminator
from tfcgan_tpu_torch.models.layers import init_normal_, without_draws
from tfcgan_tpu_torch.models.resnet_gen import ResNetGenerator
from tfcgan_tpu_torch.ops.gan_losses import lsgan_loss
from tfcgan_tpu_torch.parallel.mesh import active_mesh, all_gather_batch, local_part
from tfcgan_tpu_torch.parallel.spatial import active_rows, gather_spatial, share_mean

BUFFER_SIZE = 50


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


class CycleDiscriminator(StridedPatchDiscriminator):
    """4 stride-2 conv blocks and the head ZeroPad2d((1, 0, 1, 0)) + conv(k4,
    p1) as one conv with padding ((2, 1), (2, 1)), with a bias (torch's
    default, unlike the TFC-GAN PatchGAN head)."""

    def __init__(self, in_channels: int = 3, **kw):
        super().__init__(in_channels, head_kernel=4, head_padding=((2, 1), (2, 1)),
                         head_bias=True, **kw)


def replay_push_sample(buffer: dict, fakes: torch.Tensor, swap: torch.Tensor,
                       slots: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """The reference's ``ReplayBuffer.push_and_pop`` over a batch at once, as
    the JAX function computes it: ``buffer`` {"data": (S, H, W, C) float32,
    "count": 0-dim integer}, ``fakes`` (N, H, W, C), the draws ``swap`` (N,)
    bool (p = 0.5) and ``slots`` (N,) integers in [0, S).

    Element i fills slot count + i while that is below S and returns itself;
    once the buffer is full it returns the content of ``slots[i]`` and writes
    itself there when ``swap[i]``, else it returns itself. Two rules of the
    JAX function are kept: the returned images read the buffer as it was
    before the batch (a swap into a slot the same batch fills returns the
    slot's old content, zeros while the buffer fills), and where several
    elements share a slot the last in batch order decides it, even when that
    element does not write (it writes the old content back), as XLA's
    scatter does on the CPU. ``index_put_`` leaves duplicates undefined on
    CUDA, so the winner is found by a max over element indices."""
    data, count = buffer["data"], buffer["count"]
    size, n = data.shape[0], fakes.shape[0]
    idx = count + torch.arange(n, device=data.device)
    filling = idx < size
    write_slot = torch.where(filling, idx.clamp(0, size - 1), slots)
    do_write = filling | swap
    stored = data[write_slot]
    fakes = fakes.to(data.dtype)
    out = torch.where((~filling & swap)[:, None, None, None], stored, fakes)
    new_vals = torch.where(do_write[:, None, None, None], fakes, stored)
    winner = torch.full((size,), -1, dtype=torch.int64, device=data.device).scatter_reduce(
        0, write_slot, torch.arange(n, device=data.device), reduce="amax")
    data = torch.where((winner >= 0)[:, None, None, None], new_vals[winner.clamp_min(0)], data)
    return {"data": data, "count": torch.clamp(count + n, max=size)}, out


@dataclasses.dataclass
class CycleDraws:
    """The replay buffers' draws: a coin (True = swap) and a slot an image."""

    PER_SAMPLE: ClassVar[tuple[str, ...]] = ()

    swap_a: torch.Tensor
    slots_a: torch.Tensor
    swap_b: torch.Tensor
    slots_b: torch.Tensor


def build_generators(cfg: ExperimentConfig, device,
                     generator: torch.Generator | None = None) -> nn.ModuleDict:
    """{"G_AB", "G_BA"} on ``device`` in eval mode, weights drawn from
    ``generator`` (load a state dict over them for trained weights); the
    layout of ``recipe.G``."""
    if cfg.recipe != "cyclegan":
        raise ValueError(f"{cfg.name!r} is not a cyclegan experiment")
    ch, blocks = cfg.data.channels, int(cfg.extra.get("resnet_blocks", 9))
    kw = dict(num_blocks=blocks, dtype=_dtype(cfg), device=device, generator=generator)
    return nn.ModuleDict({"G_AB": ResNetGenerator(ch, ch, **kw),
                          "G_BA": ResNetGenerator(ch, ch, **kw)}).eval()


class CycleGANRecipe:
    name = "cyclegan"

    def __init__(self, cfg: ExperimentConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        ch = cfg.data.channels
        kw = dict(dtype=_dtype(cfg), device=device)
        with without_draws():  # init, a checkpoint or the bridge fills them
            self.G = build_generators(cfg, device).train()
            self.D = nn.ModuleDict({"D_A": CycleDiscriminator(ch, **kw),
                                    "D_B": CycleDiscriminator(ch, **kw)})
        self.lpips = None
        self.lambda_cyc = cfg.extra.get("lambda_cyc", 10.0)
        self.lambda_id = cfg.extra.get("lambda_id", 5.0)

    def init(self, generator: torch.Generator) -> None:
        """Draw every module's weights from ``generator``."""
        init_normal_(self.G, generator)
        for d in self.D.values():
            d.reset_parameters(generator)

    def initial_extra(self) -> dict:
        """Two empty float32 buffers of ``BUFFER_SIZE`` images and their counts."""
        size, ch = self.cfg.data.image_size, self.cfg.data.channels

        def empty():
            return {"data": torch.zeros(BUFFER_SIZE, size, size, ch, device=self.device),
                    "count": torch.zeros((), dtype=torch.int64, device=self.device)}

        return {"buf_A": empty(), "buf_B": empty()}

    def draw(self, generator: torch.Generator, batch: dict) -> CycleDraws:
        n, dev = batch["A"].shape[0], generator.device

        def coins():
            return torch.rand(n, generator=generator, device=dev) < 0.5

        def slots():
            return torch.randint(0, BUFFER_SIZE, (n,), generator=generator, device=dev)

        return CycleDraws(coins(), slots(), coins(), slots())

    def g_loss(self, batch: dict, draws: CycleDraws | None = None
               ) -> tuple[torch.Tensor, dict, dict]:
        a, b = batch["A"], batch["B"]
        g_ab, g_ba, d_a, d_b = self.G["G_AB"], self.G["G_BA"], self.D["D_A"], self.D["D_B"]
        rows = active_rows()
        logit_rows = d_a.out_rows(rows)

        def l1(x, y):
            return share_mean((x.float() - y).abs(), rows)

        fake_b = g_ab(a, rows)
        fake_a = g_ba(b, rows)
        loss_id = 0.5 * (l1(g_ba(a, rows), a) + l1(g_ab(b, rows), b))
        loss_gan = 0.5 * (lsgan_loss(d_b(fake_b, rows), 1.0, logit_rows)
                          + lsgan_loss(d_a(fake_a, rows), 1.0, logit_rows))
        loss_cyc = 0.5 * (l1(g_ba(fake_b, rows), a) + l1(g_ab(fake_a, rows), b))
        total = loss_gan + self.lambda_cyc * loss_cyc + self.lambda_id * loss_id
        aux = {"fake_a": fake_a.detach(), "fake_b": fake_b.detach()}
        metrics = {"loss_G": total, "g_adv": loss_gan, "g_cycle": loss_cyc, "g_id": loss_id}
        return total, aux, metrics

    def pre_d(self, extra: dict, aux: dict, draws: CycleDraws) -> tuple[dict, dict]:
        """Push the step's fakes through the replay buffers. In a
        data-parallel step every rank pushes the global batch's fakes (all
        gathered, and on row shards their rows gathered too) with the global
        draws, as the JAX step pushes its sharded batch, so the buffers stay
        the same on every rank; each rank keeps its share (and rows) of the
        returned images."""
        mesh, rows = active_mesh(), active_rows()

        def whole(x):
            return gather_spatial(all_gather_batch(x, mesh), rows)

        def mine(x):
            x = local_part(x, mesh)
            return x if rows is None else rows.cut(x).contiguous()

        buf_a, fa = replay_push_sample(extra["buf_A"], whole(aux["fake_a"]), draws.swap_a,
                                       draws.slots_a)
        buf_b, fb = replay_push_sample(extra["buf_B"], whole(aux["fake_b"]), draws.swap_b,
                                       draws.slots_b)
        return {"buf_A": buf_a, "buf_B": buf_b}, {
            **aux, "fake_a_buf": mine(fa), "fake_b_buf": mine(fb)}

    def d_loss(self, batch: dict, aux: dict) -> tuple[torch.Tensor, dict]:
        a, b = batch["A"], batch["B"]
        d_a, d_b = self.D["D_A"], self.D["D_B"]
        rows = active_rows()
        lr = d_a.out_rows(rows)
        loss_da = 0.5 * (lsgan_loss(d_a(a, rows), 1.0, lr)
                         + lsgan_loss(d_a(aux["fake_a_buf"], rows), 0.0, lr))
        loss_db = 0.5 * (lsgan_loss(d_b(b, rows), 1.0, lr)
                         + lsgan_loss(d_b(aux["fake_b_buf"], rows), 0.0, lr))
        # the sum, so that each D sees exactly its own loss's gradient
        loss = loss_da + loss_db
        return loss, {"loss_D": 0.5 * loss, "d_A": loss_da, "d_B": loss_db}
