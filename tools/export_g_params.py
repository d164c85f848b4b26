"""Export the generator of a JAX TFC-GAN checkpoint to ``g_params.npz``, the
weights file of the PyTorch port (``tfcgan_tpu_torch.cli test --params``).

    python tools/export_g_params.py --experiment fft_glo \
        --checkpoint runs/checkpoints/step_0001000 --out g_params.npz

The checkpoint is restored as ``tfcgan_tpu.cli test`` restores it; the npz
holds the ``params["G"]`` tree as float32 arrays under "/"-joined keys
("down1/conv/kernel", ...), which ``tfcgan_tpu_torch.bridge`` maps to the
port's state dict; for a debiased experiment (``fft_patch_debiased`` and its
V1-V6) the conditional G, "label_fc/..." and "unet/...", which
``bridge.load_generator_npz`` recognises. For an stn experiment (``--experiment stn_newmodel3``) it
holds the whole generator side, "G1/...", "G2/..." and "STN/..."; for
``--experiment nemar`` the translator and the registration net, "T/..." and
"R/..."; for a diffusion experiment (``tfc_diff``, ``tfc_diff_label``,
``tfc_diff_hybrid``) the denoiser "unet/..." and, where the variant has them,
"class_emb" and "G/..."; for ``--experiment cyclegan`` both generators,
"G_AB/..." and "G_BA/..."; for a thermalgan experiment (``thermalgan``,
``thermalgan_bn``) both stages and the encoder, "G1/...", "E/..." and "G2/...".
"""

from __future__ import annotations

import argparse
import os
import sys
from collections.abc import Mapping

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flat_g_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested params -> {"a/b/c": float32 array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flat_g_params(value, path))
        else:
            flat[path] = np.asarray(value, dtype=np.float32)
    return flat


def save_g_params(g_params: Mapping, path: str) -> None:
    """Write the ``params["G"]`` tree to ``path`` (.npz)."""
    np.savez(path, **flat_g_params(g_params))


def restore_g_params(experiment: str, checkpoint: str) -> Mapping:
    import jax

    from tfcgan_tpu.config import get_experiment
    from tfcgan_tpu.data.synth import synthetic_batch
    from tfcgan_tpu.recipes import build_recipe
    from tfcgan_tpu.train.checkpoint import restore_checkpoint
    from tfcgan_tpu.train.trainer import Trainer

    cfg = get_experiment(experiment)
    recipe = build_recipe(cfg)
    trainer = Trainer(cfg, recipe)
    first = synthetic_batch(batch_size=jax.device_count(), image_size=cfg.data.image_size,
                            with_labels=cfg.loss.conditional or cfg.recipe == "diffusion")
    template = trainer.init_state(jax.random.PRNGKey(0), first)
    state = restore_checkpoint(checkpoint, jax.device_get(template))
    g_params = jax.device_get(state.g_params)
    return g_params if cfg.recipe != "tfcgan" else g_params["G"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experiment", default="fft_glo")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", default="g_params.npz")
    args = p.parse_args(argv)
    save_g_params(restore_g_params(args.experiment, args.checkpoint), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
