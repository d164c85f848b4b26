"""Face-landmark overlays for checking a registration by eye, port of
``tfcgan_tpu.evaluation.face_mesh``.

VTF-STN runs MediaPipe FaceMesh over the cropped real_A / reg_B / real_B
directories and draws the landmark tessellation over each image. Here:

- ``draw_landmarks``, the drawing core: any (x, y) landmarks and connection
  list over a uint8 image, with PIL;
- ``detect_landmarks_mediapipe``, the detector with the reference's FaceMesh
  settings (static images, refined landmarks, one face, detection confidence
  0.3). MediaPipe is optional: without it the detector raises the JAX
  package's ``ImportError``, and ``overlay_image`` / ``overlay_directory``
  take any other ``detector``.
"""

from __future__ import annotations

import os
from collections.abc import Iterable, Sequence

import numpy as np


def _require_mediapipe():
    try:
        import mediapipe as mp  # type: ignore
    except ImportError as e:
        raise ImportError(
            "face-mesh landmark *detection* needs the optional 'mediapipe' "
            "package (the drawing core in this module works without it — "
            "pass your own landmarks to draw_landmarks)."
        ) from e
    return mp


def detect_landmarks_mediapipe(image: np.ndarray):
    """MediaPipe FaceMesh with the reference's settings. image: (H, W, 3)
    uint8 RGB -> ((N, 2) float32 pixel coordinates, connection index pairs),
    or None when no face is found (the reference skips such images)."""
    mp = _require_mediapipe()
    fm = mp.solutions.face_mesh
    with fm.FaceMesh(static_image_mode=True, refine_landmarks=True, max_num_faces=1,
                     min_detection_confidence=0.3) as mesh:
        results = mesh.process(image)
    if not results.multi_face_landmarks:
        return None
    h, w = image.shape[:2]
    lm = results.multi_face_landmarks[0].landmark
    pts = np.array([[p.x * w, p.y * h] for p in lm], np.float32)
    return pts, list(fm.FACEMESH_TESSELATION)


def draw_landmarks(image: np.ndarray, points: np.ndarray,
                   connections: Iterable[Sequence[int]] = (), point_color=(0, 255, 0),
                   line_color=(192, 192, 192), radius: int = 1) -> np.ndarray:
    """A copy of ``image`` ((H, W, 3) uint8) with the connections as 1-pixel
    lines and the landmarks ((N, 2) pixel coordinates) as dots."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image.copy())
    draw = ImageDraw.Draw(img)
    pts = np.asarray(points, np.float32)
    for a, b in connections:
        if a < len(pts) and b < len(pts):
            draw.line([tuple(pts[a]), tuple(pts[b])], fill=tuple(line_color))
    for x, y in pts:
        draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=tuple(point_color))
    return np.asarray(img)


def overlay_image(img_path: str, save_dir: str, detector=None) -> bool:
    """Draw the landmarks of one image into ``save_dir`` (same file name);
    returns whether a face was found. ``detector``: image -> (points,
    connections) or None; MediaPipe's by default."""
    from PIL import Image

    detector = detector or detect_landmarks_mediapipe
    with Image.open(img_path) as f:
        image = np.asarray(f.convert("RGB"))
    det = detector(image)
    if det is None:
        return False
    out = draw_landmarks(image, det[0], det[1])
    os.makedirs(save_dir, exist_ok=True)
    Image.fromarray(out).save(os.path.join(save_dir, os.path.basename(img_path)))
    return True


def overlay_directory(src_dir: str, save_dir: str, detector=None) -> int:
    """``overlay_image`` over every image of ``src_dir``; returns the number of
    faces found. Unreadable files and images without a face are skipped; a
    missing detector package raises."""
    n = 0
    for f in sorted(os.listdir(src_dir)):
        if f.startswith("."):
            continue
        try:
            n += bool(overlay_image(os.path.join(src_dir, f), save_dir, detector))
        except (OSError, ValueError):
            continue
    return n
