"""Fit the port's NIQE pristine model on the synthetic clean scenes, port of
``tools/fit_niqe_pristine.py``.

The canonical NIQE pristine model (125 natural images, modelparameters.mat)
cannot be fetched here, so the 36-dimensional Gaussian is fitted on a
deterministic corpus of the repo's procedural scenes: 32 textured face scenes
of 288², ``RandomState(7)`` (``data/synth.textured_face_scene``; the plain
blob scenes are piecewise smooth, and a model fitted on them barely reacts to
blur). It writes ``tfcgan_tpu_torch/evaluation/niqe_pristine.npz`` and prints
the clean, +noise and +blur scores of two held-out scenes (``RandomState(11)``).
Host code only: numpy and scipy.

    python tools/fit_niqe_pristine_torch.py [--out PATH]
"""

import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from tfcgan_tpu_torch.data.synth import textured_face_scene  # noqa: E402
from tfcgan_tpu_torch.evaluation.niqe import fit_niqe_model, niqe  # noqa: E402

DEFAULT_OUT = os.path.join(_ROOT, "tfcgan_tpu_torch", "evaluation", "niqe_pristine.npz")


def corpus(n_faces: int = 32, size: int = 288, seed: int = 7) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return list(textured_face_scene(rng, n_faces, size) * 255.0)


def sanity_scores(model) -> list[tuple[float, float, float]]:
    """(clean, +noise sigma 25, +blur sigma 4) NIQE of two held-out scenes."""
    from scipy import ndimage

    rng = np.random.RandomState(11)
    scores = []
    for im in textured_face_scene(rng, 2, 288) * 255.0:
        noisy = np.clip(im + rng.randn(*im.shape) * 25.0, 0, 255)
        scores.append((niqe(im, model), niqe(noisy, model),
                       niqe(ndimage.gaussian_filter(im, 4.0), model)))
    return scores


def main(out: str = DEFAULT_OUT) -> tuple[np.ndarray, np.ndarray]:
    """Fit on the corpus above, write ``out``."""
    mu, cov = fit_niqe_model(corpus())
    np.savez(out, mu=mu, cov=cov)
    print(f"wrote {out}: mu {mu.shape}, cov {cov.shape}")
    return mu, cov


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    model = main(ap.parse_args().out)
    for i, (clean, noisy, blurred) in enumerate(sanity_scores(model)):
        print(f"scene {i}: clean {clean:.2f}  +noise {noisy:.2f}  +blur {blurred:.2f}")
