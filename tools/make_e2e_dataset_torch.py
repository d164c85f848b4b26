"""Synthetic A|B pair dataset on disk for the end-to-end CLI journeys, port of
``tools/make_e2e_dataset.py`` (the same flags, layout and PNG bytes).

Side-by-side A|B PNGs in the pix2pix layout, root/{train,test}/*.png, from
one of two scene generators:

- ``--scene blocks`` (default; the fft_glo journey): B is A over smooth random
  block fields with its channels rolled and inverted, an exactly
  representable mapping (a generator that learns nothing scores about 8 dB).
- ``--scene face`` (the STN journey): the procedural visible/thermal face
  pairs of ``data/synth.py``. The blocks scene is a poor registration target:
  its autocorrelation dies at the 8 px block size, so misalignments of a few
  pixels sit outside any loss basin.

With ``--warp-b`` the B side is misregistered by a small random affine
(rotation +-4 degrees, translation +-6 px); for the test split the B before
the warp is also saved to ``root/test_aligned_B/``, the ground truth of
``cli eval-reg``.

    python tools/make_e2e_dataset_torch.py --root DIR [--n 512] [--test 32]
        [--size 256] [--seed 0] [--scene blocks|face] [--warp-b]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np


def _warp_u8(rng: np.random.RandomState, img_u8: np.ndarray) -> np.ndarray:
    """Small random affine (PIL): rotation +-4 degrees, translation +-6 px."""
    from PIL import Image

    deg = float(rng.uniform(-4.0, 4.0))
    tx, ty = (float(rng.uniform(-6.0, 6.0)) for _ in range(2))
    img = Image.fromarray(img_u8)
    return np.asarray(
        img.rotate(deg, resample=Image.BILINEAR, translate=(tx, ty),
                   fillcolor=tuple(int(v) for v in img_u8.reshape(-1, 3).mean(0))))


def make_pair(rng: np.random.RandomState, size: int, warp_b: bool = False,
              scene: str = "blocks") -> tuple[np.ndarray, np.ndarray]:
    """Returns (A|B side by side uint8, B_aligned uint8)."""
    def to_u8(x):
        return np.round((x * 0.5 + 0.5) * 255.0).astype(np.uint8)

    if scene == "face":
        from tfcgan_tpu_torch.data.synth import _face_scene, face_pair

        a, b = face_pair(_face_scene(rng, 1, size)[0])  # (H, W, 3) in [-1, 1]
        a8, b8 = to_u8(a), to_u8(b)
    else:
        a = rng.randn(size // 8, size // 8, 3).astype(np.float32)
        a = np.tanh(a.repeat(8, axis=0).repeat(8, axis=1))
        b = -np.roll(a, 1, axis=-1)  # the target mapping
        a8, b8 = to_u8(a), to_u8(b)
    b8_aligned = b8
    if warp_b:
        b8 = _warp_u8(rng, b8)
    return np.concatenate([a8, b8], axis=1), b8_aligned


def main(argv=None) -> None:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "e2e_pairs"))
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--test", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="blocks", choices=["blocks", "face"])
    ap.add_argument("--warp-b", action="store_true",
                    help="misalign the B side with a small random affine "
                         "(the STN training regime)")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    for split, count in (("train", args.n), ("test", args.test)):
        d = os.path.join(args.root, split)
        os.makedirs(d, exist_ok=True)
        aligned_d = None
        if args.warp_b and split == "test":
            aligned_d = os.path.join(args.root, "test_aligned_B")
            os.makedirs(aligned_d, exist_ok=True)
        have = len([f for f in os.listdir(d) if f.endswith(".png")])
        for i in range(have, count):
            pair, b_aligned = make_pair(rng, args.size, warp_b=args.warp_b, scene=args.scene)
            Image.fromarray(pair).save(os.path.join(d, f"{i:05d}.png"))
            if aligned_d is not None:
                Image.fromarray(b_aligned).save(os.path.join(aligned_d, f"{i:05d}.png"))
        print(f"{split}: {max(have, count)} pairs at {d}")


if __name__ == "__main__":
    main()
