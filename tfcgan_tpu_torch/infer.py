"""Inference ("serve") path, port of ``tfcgan_tpu.infer`` for the tfcgan, stn,
nemar, cyclegan and thermalgan recipes, and the diffusion family's sampling
(the JAX CLI's ``gen``).

``Inferencer`` runs the eval-mode generator(s) on the device that holds their
weights under ``torch.inference_mode``; ``run_test_set`` streams batches and
writes the reference-style stacked PNGs: real_A | fake_B | real_B vertically
for tfcgan (and, with ``save_spectra``, the fake/real log-magnitude spectra
side by side), real_A | real_B | warped_B | fake_A1 | fake_A2 | fake_B for
stn, real_A | real_B | registered_A | fake_B | fake_TR_B | fake_RT_B for
nemar, real_A | fake_B | real_B | fake_A for cyclegan (G_AB(A) and G_BA(B)),
and the tfcgan stack for thermalgan, whose fake_B is G2(G1(A, T_B)) with
T_B normalised along H for both variants (the JAX Inferencer does so for
thermalgan_bn too, which trained on raw temperatures: mirrored, not fixed).
A debiased (conditional) experiment's G takes the batch's
``LAB3`` labels as floats, the saliency-mask experiment's the image with its
mask as a 4th channel; both write the tfcgan stacks. For a diffusion
experiment a call samples x_0 over the whole ancestral chain and
``run_test_set`` writes real_A | sample.

With a ``mesh`` (``parallel.make_mesh``) the serve path is data-parallel, as
the JAX Inferencer is over its mesh: a batch is padded with copies of its
first sample to a multiple of the data axis, each data share serves its
samples, ``parallel.all_gather_batch`` collects the outputs over the data
group and the padding is trimmed; ``run_test_set`` writes on rank 0 only.
Every rank calls with the same batches. The weights are served whole and
replicated, as the JAX Inferencer replicates them: on a (data, tensor) mesh
the ranks of a tensor group serve the same share with the same weights, and
a generator taken from a sharded training state is gathered first
(``parallel.tensor.gathered_copy``, a collective over its tensor group). On
a mesh with a spatial axis the serve path is the JAX Inferencer's there too:
sharded over the data axis only, the spatial ranks of a data share serving
the same whole images, replicated (no row shards: serving needs no halo). A
batch-coupled op (thermalgan_bn's ``TrainBatchNorm``) reads the padded
batch's moments, pad copies included, as the JAX reference does. The
diffusion sampler is not data-parallel (its noise is drawn for the batch it
is given).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tfcgan_tpu_torch.config import ExperimentConfig
from tfcgan_tpu_torch.evaluation.suite import save_image_grid
from tfcgan_tpu_torch.ops.fftloss import fft_log_magnitude
from tfcgan_tpu_torch.parallel.mesh import all_gather_batch, local_part, loss_mesh
from tfcgan_tpu_torch.parallel.tensor import gathered_copy
from tfcgan_tpu_torch.recipes.diffusion import diffusion_sample, schedule_of
from tfcgan_tpu_torch.recipes.nemar import nemar_forward
from tfcgan_tpu_torch.recipes.stn import stn_condition, stn_serve
from tfcgan_tpu_torch.recipes.tfcgan import g_input
from tfcgan_tpu_torch.recipes.thermalgan import thermalgan_serve

# the images of a stack, top to bottom: real_A and real_B from the batch, the
# others from the forward's outputs
STACKS = {"stn": ("real_A", "real_B", "warped_B", "fake_A1", "fake_A2", "fake_B"),
          "nemar": ("real_A", "real_B", "registered_A", "fake_B", "fake_TR_B", "fake_RT_B"),
          "cyclegan": ("real_A", "fake_B", "real_B", "fake_A")}


class Inferencer:
    """Eval-mode generation on the device that holds the weights of
    ``generator``: the G of ``recipes.tfcgan.build_generator``, the
    {"G1", "G2", "STN"} modules of ``recipes.stn.build_generators``, the
    {"T", "R"} modules of ``recipes.nemar.build_generators``, the {"G_AB",
    "G_BA"} of ``recipes.cyclegan.build_generators``, the {"G1", "E", "G2"}
    of ``recipes.thermalgan.build_generators``, or the
    ``DiffusionGenerators`` of ``recipes.diffusion.build_generators``."""

    def __init__(self, cfg: ExperimentConfig, generator: torch.nn.Module, mesh=None):
        if cfg.recipe not in ("tfcgan", "stn", "nemar", "diffusion", "cyclegan", "thermalgan"):
            raise ValueError(f"no inference path for recipe {cfg.recipe!r}")
        if mesh is not None and cfg.recipe == "diffusion":
            raise NotImplementedError("the diffusion sampler is not data-parallel: serve it "
                                      "without a mesh")
        self.cfg = cfg
        self.generator = gathered_copy(generator).eval()
        self.device = next(generator.parameters()).device
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0

    def __call__(self, batch: dict, seed: int = 0) -> torch.Tensor | dict[str, torch.Tensor]:
        """The outputs for ``batch`` (see ``_forward``); under a mesh every
        rank computes its share and gets the whole batch's outputs."""
        if self.mesh is None:
            return self._forward(batch, seed)
        n = int(np.shape(batch["A"])[0])
        pad = (-n) % self.mesh.data_size
        share = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if pad:
                v = torch.cat([v, v[:1].expand(pad, *v.shape[1:])])
            share[k] = local_part(v, self.mesh)
        with loss_mesh(self.mesh):
            out = self._forward(share, seed)

        def whole(x):
            return all_gather_batch(x.contiguous(), self.mesh)[:n]

        return {k: whole(v) for k, v in out.items()} if isinstance(out, dict) else whole(out)

    def _forward(self, batch: dict, seed: int = 0) -> torch.Tensor | dict[str, torch.Tensor]:
        """batch["A"] (and, for stn, nemar and cyclegan, batch["B"]; for
        thermalgan batch["T_B"], (N, H, W) Celsius; for a debiased
        experiment batch["LAB3"], (N, 3) integers): (N, H, W, 3) in
        [-1, 1], numpy or tensor -> on the device, fake_B (tfcgan,
        thermalgan), {"fake_B", "fake_A1", "warped_B", "fake_A2"} (stn),
        {"registered_A", "fake_B", "fake_TR_B", "fake_RT_B"} (nemar),
        {"fake_B", "fake_A"} (cyclegan) or, for a diffusion experiment, the
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
            if self.cfg.recipe == "tfcgan" and self.cfg.loss.conditional:
                if "LAB3" not in batch:
                    # the JAX Inferencer conditions such a batch on (0, 0, 0)
                    raise ValueError(f"{self.cfg.name!r} is conditional: the batch needs its "
                                     "(gender, ethnicity, age) labels as LAB3")
                lab3 = torch.as_tensor(batch["LAB3"]).to(self.device, torch.float32)
                return self.generator(a, lab3)
            if self.cfg.recipe == "tfcgan":
                return self.generator(g_input(self.cfg, a))
            if self.cfg.recipe == "thermalgan":
                t_b = torch.as_tensor(batch["T_B"]).to(self.device, torch.float32)
                return thermalgan_serve(self.generator, a, t_b)
            b = torch.as_tensor(batch["B"]).to(self.device, torch.float32)
            if self.cfg.recipe == "cyclegan":
                return {"fake_B": self.generator["G_AB"](a), "fake_A": self.generator["G_BA"](b)}
            if self.cfg.recipe == "stn":
                return stn_serve(self.generator, stn_condition(self.cfg), a, b)
            return nemar_forward(self.generator, a, b)[0]

    def _run_stack_test_set(self, batches, out_dir: str) -> int:
        """One ``STACKS`` stack of the recipe per image."""
        n = 0
        for batch in batches:
            out = self(batch)
            real = {"real_A": batch["A"], "real_B": batch["B"]}
            stacks = [np.asarray(real[k]) if k in real else out[k].float().cpu().numpy()
                      for k in STACKS[self.cfg.recipe]]
            for i in range(stacks[0].shape[0]):
                self._save([s[i] for s in stacks], os.path.join(out_dir, f"{n:05d}.png"))
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
                self._save([a[i], img], os.path.join(out_dir, f"{n:05d}.png"))
                n += 1
        return n

    def _save(self, images: list, path: str) -> None:
        if self.writes:
            save_image_grid(images, path)

    def run_test_set(self, batches, out_dir: str, save_spectra: bool = False,
                     seed: int = 0) -> int:
        """Write one stack per image (and, for tfcgan and thermalgan, its
        spectra); returns images written (by rank 0, under a mesh). ``seed``
        is the diffusion sampler's."""
        if self.writes:
            os.makedirs(out_dir, exist_ok=True)
        if self.cfg.recipe == "diffusion":
            return self._run_sampling_test_set(batches, out_dir, seed)
        if self.cfg.recipe in STACKS:
            return self._run_stack_test_set(batches, out_dir)
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
                self._save([a[i], fake[i], b[i]], os.path.join(out_dir, f"{n:05d}.png"))
                if save_spectra:
                    lo = min(spec_f[i].min(), spec_r[i].min())
                    hi = max(spec_f[i].max(), spec_r[i].max())

                    def norm(s):
                        return ((s - lo) / max(hi - lo, 1e-9) * 2 - 1)[..., None].repeat(3, -1)

                    self._save([norm(spec_f[i]), norm(spec_r[i])],
                               os.path.join(out_dir, "spectra", f"{n:05d}_mag.png"))
                n += 1
        return n
