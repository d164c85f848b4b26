"""No-reference IQA of the acceptance protocol, port of
``tfcgan_tpu.evaluation.iqa``: one score an image for each of the metrics
the reference runs over fake_B and real_B (MANIQA, DBCNN, NIQE).

- ``niqe`` runs here (``evaluation/niqe.py``, no learned weights), on 96x96
  patches, shrunk to an even size for images under 192 pixels;
- ``maniqa`` and ``dbcnn`` are learned models whose converted weights are not
  in the repository: asking for one raises ``IQAWeightsUnavailable`` with the
  JAX package's message (the weights' expected path and how to convert them).
"""

from __future__ import annotations

import os

import numpy as np


class IQAWeightsUnavailable(RuntimeError):
    pass


def _weights_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "weights",
    )


def _score_niqe(images: list[np.ndarray]) -> np.ndarray:
    from tfcgan_tpu_torch.evaluation.niqe import load_pristine_model, niqe

    model = load_pristine_model()

    def patch(im):  # the canonical 96, shrunk (to an even size) for small images
        return min(96, (min(im.shape[0], im.shape[1]) // 2) * 2)

    return np.asarray([niqe(im, model, patch=patch(im)) for im in images])


def _gated(name: str, filename: str):
    def scorer(images):
        path = os.path.join(_weights_dir(), filename)
        raise IQAWeightsUnavailable(
            f"{name} is a learned NR-IQA model whose pretrained checkpoint is "
            f"egress-blocked in this environment (weights expected at {path}; "
            f"present: {os.path.exists(path)}). Convert the IQA-PyTorch "
            f"checkpoint with tools/convert_iqa.py — see README 'Pretrained "
            f"weights'. The classical NIQE metric runs natively (--iqa niqe)."
        )

    return scorer


IQA_METRICS = {
    "niqe": _score_niqe,
    "maniqa": _gated("MANIQA", "maniqa.npz"),
    "dbcnn": _gated("DBCNN", "dbcnn.npz"),
}


def compute_iqa(images: list[np.ndarray], metrics=("niqe",)) -> dict[str, np.ndarray]:
    """Per-image scores of uint8-range images, one array a requested metric."""
    return {m: IQA_METRICS[m](images) for m in metrics}
