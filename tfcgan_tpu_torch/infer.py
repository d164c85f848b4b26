"""Inference ("serve") path, port of ``tfcgan_tpu.infer`` for the tfcgan, stn
and nemar recipes, and the diffusion family's sampling (the JAX CLI's ``gen``).

``Inferencer`` runs the eval-mode generator(s) on the device that holds their
weights under ``torch.inference_mode``; ``run_test_set`` streams batches and
writes the reference-style stacked PNGs: real_A | fake_B | real_B vertically
for tfcgan (and, with ``save_spectra``, the fake/real log-magnitude spectra
side by side), real_A | real_B | warped_B | fake_A1 | fake_A2 | fake_B for
stn, real_A | real_B | registered_A | fake_B | fake_TR_B | fake_RT_B for
nemar. For a diffusion experiment a call samples x_0 over the whole ancestral
chain and ``run_test_set`` writes real_A | sample. The other recipes and the
multi-device mesh are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.evaluation.suite import save_image_grid
from tfcgan_tpu_torch.ops.fftloss import fft_log_magnitude
from tfcgan_tpu_torch.recipes.diffusion import diffusion_sample, schedule_of
from tfcgan_tpu_torch.recipes.nemar import nemar_forward
from tfcgan_tpu_torch.recipes.stn import stn_condition, stn_serve

# the generated images of a six-image stack, after real_A and real_B
STACKS = {"stn": ("warped_B", "fake_A1", "fake_A2", "fake_B"),
          "nemar": ("registered_A", "fake_B", "fake_TR_B", "fake_RT_B")}


class Inferencer:
    """Eval-mode generation on the device that holds the weights of
    ``generator``: the G of ``recipes.tfcgan.build_generator``, the
    {"G1", "G2", "STN"} modules of ``recipes.stn.build_generators``, the
    {"T", "R"} modules of ``recipes.nemar.build_generators``, or the
    ``DiffusionGenerators`` of ``recipes.diffusion.build_generators``."""

    def __init__(self, cfg: ExperimentConfig, generator: torch.nn.Module):
        if cfg.recipe not in ("tfcgan", "stn", "nemar", "diffusion") or cfg.loss.conditional:
            raise NotImplementedError(f"no inference path for {cfg.name!r} in the port yet")
        self.cfg = cfg
        self.generator = generator.eval()
        self.device = next(generator.parameters()).device

    def __call__(self, batch: dict, seed: int = 0) -> torch.Tensor | dict[str, torch.Tensor]:
        """batch["A"] (and, for stn and nemar, batch["B"]): (N, H, W, 3) in
        [-1, 1], numpy or tensor -> on the device, fake_B (tfcgan), {"fake_B",
        "fake_A1", "warped_B", "fake_A2"} (stn), {"registered_A", "fake_B",
        "fake_TR_B", "fake_RT_B"} (nemar) or, for a diffusion experiment, the
        float32 sample of the whole chain (its draws from ``seed``; class
        labels from batch["LAB"], 0 where the batch has none)."""
        a = torch.as_tensor(batch["A"]).to(self.device, torch.float32)
        if self.cfg.recipe == "diffusion":
            lab = torch.as_tensor(batch.get("LAB", np.zeros(a.shape[0], np.int64)))
            with torch.inference_mode():
                return diffusion_sample(
                    self.generator, schedule_of(self.cfg), {"A": a, "LAB": lab.to(self.device)},
                    torch.Generator(self.device).manual_seed(seed))
        with torch.inference_mode():
            if self.cfg.recipe == "tfcgan":
                return self.generator(a)
            b = torch.as_tensor(batch["B"]).to(self.device, torch.float32)
            if self.cfg.recipe == "stn":
                return stn_serve(self.generator, stn_condition(self.cfg), a, b)
            return nemar_forward(self.generator, a, b)[0]

    def _run_six_image_test_set(self, batches, out_dir: str) -> int:
        n = 0
        for batch in batches:
            out = self(batch)
            stacks = [np.asarray(batch["A"]), np.asarray(batch["B"]),
                      *(out[k].float().cpu().numpy() for k in STACKS[self.cfg.recipe])]
            for i in range(stacks[0].shape[0]):
                save_image_grid([s[i] for s in stacks], os.path.join(out_dir, f"{n:05d}.png"))
                n += 1
        return n

    def _run_sampling_test_set(self, batches, out_dir: str, seed: int) -> int:
        """real_A | sample per image; every batch samples from ``seed``, as
        the JAX CLI's ``gen`` does."""
        n = 0
        for batch in batches:
            out = self(batch, seed).cpu().numpy()
            a = np.asarray(batch["A"])
            for i in range(out.shape[0]):
                img = out[i].repeat(3, -1) if out.shape[-1] == 1 else out[i]
                save_image_grid([a[i], img], os.path.join(out_dir, f"{n:05d}.png"))
                n += 1
        return n

    def run_test_set(self, batches, out_dir: str, save_spectra: bool = False,
                     seed: int = 0) -> int:
        """Write one stack per image (and, for tfcgan, its spectra); returns
        images written. ``seed`` is the diffusion sampler's."""
        os.makedirs(out_dir, exist_ok=True)
        if self.cfg.recipe == "diffusion":
            return self._run_sampling_test_set(batches, out_dir, seed)
        if self.cfg.recipe in STACKS:
            return self._run_six_image_test_set(batches, out_dir)
        n = 0
        for batch in batches:
            fake = self(batch).float()
            if save_spectra:
                real = torch.as_tensor(batch["B"]).to(self.device, torch.float32)
                spec_f = fft_log_magnitude(fake).cpu().numpy()
                spec_r = fft_log_magnitude(real).cpu().numpy()
            fake = fake.cpu().numpy()
            a, b = np.asarray(batch["A"]), np.asarray(batch["B"])
            for i in range(fake.shape[0]):
                save_image_grid([a[i], fake[i], b[i]], os.path.join(out_dir, f"{n:05d}.png"))
                if save_spectra:
                    lo = min(spec_f[i].min(), spec_r[i].min())
                    hi = max(spec_f[i].max(), spec_r[i].max())

                    def norm(s):
                        return ((s - lo) / max(hi - lo, 1e-9) * 2 - 1)[..., None].repeat(3, -1)

                    save_image_grid([norm(spec_f[i]), norm(spec_r[i])],
                                    os.path.join(out_dir, "spectra", f"{n:05d}_mag.png"))
                n += 1
        return n
