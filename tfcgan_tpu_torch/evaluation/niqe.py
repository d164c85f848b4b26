"""NIQE, the Natural Image Quality Evaluator (no-reference IQA), port of
``tfcgan_tpu.evaluation.niqe``: numpy and scipy on the host, as in the JAX
package. The reference's acceptance protocol scores fake_B and real_B with
it (through IQA-PyTorch). Mittal, Soundararajan, Bovik, "Making a
'Completely Blind' Image Quality Analyzer", IEEE SPL 2013.

1. luma (ITU-R 601-2, PIL "L" / matlab rgb2gray coefficients);
2. MSCN coefficients ``(I - mu) / (sigma + 1)`` with a 7x7 Gaussian window,
   sigma 7/6;
3. per 96x96 patch: the GGD fit (alpha, sigma^2) of the MSCN values and the
   AGGD fits (alpha, eta, bl^2, br^2) of the 4 neighbour products (H, V, D1,
   D2): 18 features, at 2 scales: 36;
4. quality = ``sqrt(d^T pinv((S_p + S_t) / 2) d)`` between the multivariate
   Gaussian of the image's patches and the pristine model's.

As in the JAX package: the pristine model is the one fitted on the repo's
synthetic clean scenes (``tools/fit_niqe_pristine_torch.py`` refits it, byte
for byte the JAX package's file), kept here as the port's own copy of
``niqe_pristine.npz``, not the authors' 125-image model
(a converted one at ``weights/niqe_pristine.npz`` takes its place), so
scores compare within this model only; the second scale is 2x2 mean pooling,
not matlab's bicubic ``imresize(0.5)``.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage, special

# ---------------------------------------------------------------------------
# GGD / AGGD moment-matching fits (paper eqs. 2-5; the standard gamma-ratio
# lookup over a dense alpha grid).

_GAMMA_GRID = np.arange(0.2, 10.001, 0.001)
# GGD: r(alpha) = gamma(1/a)*gamma(3/a)/gamma(2/a)^2
_GGD_RATIO = (special.gamma(1.0 / _GAMMA_GRID) * special.gamma(3.0 / _GAMMA_GRID)
              / special.gamma(2.0 / _GAMMA_GRID) ** 2)
# AGGD: r_hat(alpha) = gamma(2/a)^2 / (gamma(1/a)*gamma(3/a))  (inverse form)
_AGGD_RATIO = 1.0 / _GGD_RATIO


def fit_ggd(x: np.ndarray) -> tuple[float, float]:
    """Moment-matching generalized-Gaussian fit -> (alpha, sigma^2)."""
    x = np.asarray(x, np.float64).ravel()
    sigma_sq = float(np.mean(x**2))
    e_abs = float(np.mean(np.abs(x))) + 1e-12
    rho = sigma_sq / (e_abs**2)
    alpha = float(_GAMMA_GRID[np.argmin(np.abs(_GGD_RATIO - rho))])
    return alpha, sigma_sq


def fit_aggd(x: np.ndarray) -> tuple[float, float, float, float]:
    """Asymmetric GGD fit -> (alpha, eta, bl^2, br^2).

    eta is the AGGD mean term the NIQE feature vector uses:
    ``(br - bl) * gamma(2/a) / gamma(1/a)`` with b the left/right std.
    """
    x = np.asarray(x, np.float64).ravel()
    left = x[x < 0]
    right = x[x >= 0]
    bl_sq = float(np.mean(left**2)) if left.size else 0.0
    br_sq = float(np.mean(right**2)) if right.size else 0.0
    bl = np.sqrt(bl_sq) + 1e-12
    br = np.sqrt(br_sq) + 1e-12
    gamma_hat = bl / br
    e_abs = float(np.mean(np.abs(x))) + 1e-12
    rho_hat = float(np.mean(x**2)) / (e_abs**2)
    # generalized ratio corrected for asymmetry (Lasmar et al. estimator)
    r_hat = rho_hat * (gamma_hat**3 + 1.0) * (gamma_hat + 1.0) / (gamma_hat**2 + 1.0) ** 2
    alpha = float(_GAMMA_GRID[np.argmin(np.abs(1.0 / _AGGD_RATIO - r_hat))])
    eta = (br - bl) * (special.gamma(2.0 / alpha) / special.gamma(1.0 / alpha))
    return alpha, float(eta), bl_sq, br_sq


# ---------------------------------------------------------------------------
# MSCN + per-patch features


def _gaussian_kernel7() -> np.ndarray:
    g = np.exp(-0.5 * (np.arange(7) - 3.0) ** 2 / (7.0 / 6.0) ** 2)
    g /= g.sum()
    return np.outer(g, g)


_KERN = _gaussian_kernel7()


def mscn(gray: np.ndarray) -> np.ndarray:
    """Mean-subtracted contrast-normalized coefficients of a [0,255] luma."""
    gray = np.asarray(gray, np.float64)
    mu = ndimage.correlate(gray, _KERN, mode="nearest")
    sigma = np.sqrt(np.maximum(
        ndimage.correlate(gray * gray, _KERN, mode="nearest") - mu * mu, 0.0))
    return (gray - mu) / (sigma + 1.0)


def _patch_features(m: np.ndarray) -> np.ndarray:
    """18 NIQE features of one MSCN patch."""
    feats = list(fit_ggd(m))
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):  # H, V, D1, D2
        shifted = np.roll(np.roll(m, dy, axis=0), dx, axis=1)
        feats.extend(fit_aggd((m * shifted)[1:-1, 1:-1]))
    return np.asarray(feats, np.float64)


def _luma(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    if img.ndim == 3 and img.shape[-1] == 3:
        img = img @ np.asarray([0.299, 0.587, 0.114])
    return img


def niqe_features(
    img: np.ndarray, patch: int = 96, sharpness_threshold: float | None = None,
) -> np.ndarray:
    """(n_patches, 36) feature matrix of one image (uint8-range luma or RGB).

    ``sharpness_threshold`` (0..1, fraction of the peak patch sharpness)
    enables the pristine-model patch selection from the paper (sec. III-B);
    test images use all patches, like the canonical implementation.
    """
    gray = _luma(img)
    h, w = gray.shape
    p2 = patch // 2
    # trim to a whole number of patches (canonical niqe.m behaviour)
    gray = gray[: (h // patch) * patch, : (w // patch) * patch]
    if gray.shape[0] < patch or gray.shape[1] < patch:
        raise ValueError(f"image {(h, w)} smaller than one {patch}x{patch} patch")
    scales = []
    sharp = []  # full-scale patch sharpness, same patch order at both scales
    for s, (g, p) in enumerate((
        (gray, patch),
        (gray.reshape(gray.shape[0] // 2, 2, gray.shape[1] // 2, 2).mean((1, 3)), p2),
    )):
        m = mscn(g)
        feats = []
        for i in range(0, m.shape[0] - p + 1, p):
            for j in range(0, m.shape[1] - p + 1, p):
                feats.append(_patch_features(m[i : i + p, j : j + p]))
                if s == 0 and sharpness_threshold is not None:
                    # sigma field of the full-scale patch = local sharpness
                    gp = g[i : i + p, j : j + p]
                    mu = ndimage.correlate(gp, _KERN, mode="nearest")
                    sg = np.sqrt(np.maximum(
                        ndimage.correlate(gp * gp, _KERN, mode="nearest") - mu * mu, 0.0))
                    sharp.append(float(sg.mean()))
        scales.append(np.asarray(feats))
    f = np.concatenate(scales, axis=1)  # (P, 36)
    if sharpness_threshold is not None and len(sharp) > 1:
        keep = np.asarray(sharp) > sharpness_threshold * max(sharp)
        if keep.sum() >= 2:
            f = f[keep]
    return f


# ---------------------------------------------------------------------------
# Pristine model + score


def fit_niqe_model(images, patch: int = 96, sharpness_threshold: float = 0.75):
    """Fit the pristine MVG (mu, cov) over a corpus of clean images."""
    feats = np.concatenate(
        [niqe_features(im, patch, sharpness_threshold) for im in images], axis=0
    )
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


_DEFAULT_MODEL = os.path.join(os.path.dirname(__file__), "niqe_pristine.npz")


def load_pristine_model(path: str | None = None):
    """(mu, cov): ``weights/niqe_pristine.npz`` (converted canonical model)
    if present, else the committed synthetic-fitted default."""
    if path is None:
        cand = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "weights", "niqe_pristine.npz",
        )
        path = cand if os.path.exists(cand) else _DEFAULT_MODEL
    with np.load(path) as z:
        return z["mu"], z["cov"]


def niqe(img: np.ndarray, model=None, patch: int = 96) -> float:
    """NIQE score of one image (lower = more natural w.r.t. the model)."""
    if model is None:
        model = load_pristine_model()
    mu_p, cov_p = model
    f = niqe_features(img, patch)
    mu_t = f.mean(axis=0)
    cov_t = np.cov(f, rowvar=False) if f.shape[0] > 1 else np.zeros_like(cov_p)
    d = mu_p - mu_t
    return float(np.sqrt(max(d @ np.linalg.pinv((cov_p + cov_t) / 2.0) @ d, 0.0)))
