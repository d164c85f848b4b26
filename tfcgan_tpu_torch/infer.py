"""Inference ("serve") path, port of ``tfcgan_tpu.infer`` for the tfcgan recipe.

``Inferencer`` runs the eval-mode generator on the device under
``torch.inference_mode``; ``run_test_set`` streams batches and writes the
reference-style stacked PNGs (real_A | fake_B | real_B vertically) and, with
``save_spectra``, the fake/real log-magnitude spectra side by side. The other
recipes and the multi-device mesh are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.evaluation.suite import save_image_grid
from tfcgan_tpu_torch.ops.fftloss import fft_log_magnitude


class Inferencer:
    """Eval-mode generation with ``generator`` (from ``recipes.tfcgan.build_generator``)
    on the device that holds its weights."""

    def __init__(self, cfg: ExperimentConfig, generator: torch.nn.Module):
        if cfg.recipe != "tfcgan" or cfg.loss.conditional:
            raise NotImplementedError(f"no inference path for {cfg.name!r} in the port yet")
        self.cfg = cfg
        self.generator = generator.eval()
        self.device = next(generator.parameters()).device

    def __call__(self, batch: dict) -> torch.Tensor:
        """batch["A"]: (N, H, W, 3) in [-1, 1], numpy or tensor -> fake_B on the device."""
        a = torch.as_tensor(batch["A"]).to(self.device, torch.float32)
        with torch.inference_mode():
            return self.generator(a)

    def run_test_set(self, batches, out_dir: str, save_spectra: bool = False) -> int:
        """Write one stack per image (and its spectra); returns images written."""
        os.makedirs(out_dir, exist_ok=True)
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
