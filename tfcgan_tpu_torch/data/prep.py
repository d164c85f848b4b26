"""Offline data preparation, port of ``tfcgan_tpu.data.prep``.

- ``combine_a_and_b``: same-named files of an A and a B directory side by
  side into A|B pair images (pix2pix's ``combine_A_and_B``), B resized to A's
  size by PIL's default (bicubic) filter, in threads.
- ``crop_stacks``: every vertical N-image stack of a directory into one
  directory a role (``cli prep-crop``).
- ``make_registered_dataset``: a trained STN's ``Inferencer`` over a pair set,
  written as A|warped_B pairs for re-training (VTF-STN's registered set),
  through the port's PNG encoder.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tfcgan_tpu_torch.evaluation.suite import crop_stack, to_uint8, write_png


def _combine_one(job: tuple[str, str, str]) -> None:
    from PIL import Image

    path_a, path_b, path_ab = job
    with Image.open(path_a) as fa, Image.open(path_b) as fb:
        a = fa.convert("RGB")
        b = fb.convert("RGB").resize(a.size)
    ab = Image.new("RGB", (a.size[0] * 2, a.size[1]))
    ab.paste(a, (0, 0))
    ab.paste(b, (a.size[0], 0))
    ab.save(path_ab)


def combine_a_and_b(dir_a: str, dir_b: str, dir_ab: str, workers: int = 8) -> int:
    """Pair same-named files of ``dir_a`` and ``dir_b`` side by side into
    ``dir_ab``; returns the number of pairs. Threads, not processes: PIL
    releases the GIL in its codecs, and a fork after torch has started its
    thread pools can deadlock."""
    os.makedirs(dir_ab, exist_ok=True)
    names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    jobs = [(os.path.join(dir_a, n), os.path.join(dir_b, n), os.path.join(dir_ab, n))
            for n in names]
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(_combine_one, jobs))
    else:
        for job in jobs:
            _combine_one(job)
    return len(jobs)


def crop_stacks(stack_dir: str, out_root: str, roles: list[str]) -> int:
    """Slice every vertical N-stack PNG of ``stack_dir`` into
    ``out_root/<role>/``, N = len(roles), keeping the file names; returns the
    number of stacks."""
    files = sorted(f for f in os.listdir(stack_dir) if f.endswith(".png"))
    out_dirs = [os.path.join(out_root, r) for r in roles]
    for d in out_dirs:
        os.makedirs(d, exist_ok=True)
    for f in files:
        crop_stack(os.path.join(stack_dir, f), out_dirs, num=len(roles))
    return len(files)


def make_registered_dataset(inferencer, batches, out_dir: str) -> int:
    """Warp every pair of ``batches`` with the STN of ``inferencer`` (an
    ``infer.Inferencer`` of an stn experiment) and write A | warped_B as
    ``out_dir/%05d.png``; returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for batch in batches:
        warped = inferencer(batch)["warped_B"].float().cpu().numpy()
        a = _host(batch["A"])
        for i in range(a.shape[0]):
            pair = np.concatenate([to_uint8(a[i]), to_uint8(warped[i])], axis=1)
            write_png(os.path.join(out_dir, f"{n:05d}.png"), pair)
            n += 1
    return n


def _host(x) -> np.ndarray:
    """A batch field (numpy, or a tensor on any device) as a host array."""
    return x.float().cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
