"""The port's CLI surface against the JAX CLI's, on the CPU.

Every JAX subcommand and every JAX flag has its counterpart in the port
(``--cpu`` is ``--device cpu``), read from both parsers' help. Each host
subcommand the port added runs on tiny directories beside the JAX CLI on the
same inputs: ``prep-combine``, ``prep-crop`` and ``prep-morphs`` write PNGs
whose decoded pixels equal the JAX ones, ``gallery`` the same page, and
``mesh`` refuses with the JAX CLI's mediapipe message (mediapipe is not
installed). ``eval-reg`` and ``eval --iqa`` are held to the JAX CLI's CSV in
test_torch_regmetrics.py and test_torch_niqe_iqa.py. About 5 s on one worker.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from tfcgan_tpu import cli as jax_cli
from tfcgan_tpu_torch import cli

SUBCOMMANDS = ("train", "test", "gen", "eval", "eval-reg", "prep-combine", "prep-crop",
               "prep-morphs", "gallery", "mesh")


def _help(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as info:
        main([*argv, "--help"])
    assert info.value.code == 0
    return out.getvalue()


def _flags(text: str) -> set[str]:
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", text)) - {"--help"}


def test_every_jax_subcommand_and_flag_has_a_counterpart():
    top = _help(cli.main, [])
    for name in SUBCOMMANDS:
        assert name in _help(jax_cli.main, [])
        assert name in top, name
        ours, theirs = _flags(_help(cli.main, [name])), _flags(_help(jax_cli.main, [name]))
        missing = {f for f in theirs if f != "--cpu"} - ours
        assert not missing, (name, missing)
        assert "--device" in ours, name
    assert "not ported" not in _help(cli.main, ["train"])


def _png_dir(d, shapes, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, shape in enumerate(shapes):
        Image.fromarray(rng.randint(0, 256, shape, np.uint8)).save(os.path.join(d, f"{i:03d}.png"))


def _decoded(d):
    return {f: np.asarray(Image.open(os.path.join(d, f)).convert("RGB"))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _assert_same_pngs(got_dir, want_dir, count):
    got, want = _decoded(got_dir), _decoded(want_dir)
    assert list(got) == list(want) and len(got) == count
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def _both(tmp_path, argv, dirs):
    """Run ``argv`` through both CLIs, each writing under its own copy of the
    output ``dirs`` (argument name -> subdirectory)."""
    for side, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, ["--cpu"])):
        outs = [x for k, d in dirs.items() for x in (k, str(tmp_path / side / d))]
        main([*argv, *outs, *device])


def test_prep_combine_crop_and_morphs_match_the_jax_cli(tmp_path):
    _png_dir(tmp_path / "A", [(24, 20, 3)] * 3, seed=0)
    _png_dir(tmp_path / "B", [(30, 18, 3)] * 3, seed=1)  # resized to A's size
    _both(tmp_path, ["prep-combine", "--dir-a", str(tmp_path / "A"), "--dir-b",
                     str(tmp_path / "B")], {"--dir-ab": "ab"})
    _assert_same_pngs(tmp_path / "port" / "ab", tmp_path / "jax" / "ab", 3)

    _png_dir(tmp_path / "stacks", [(6 * 16, 16, 3)] * 2, seed=2)
    roles = "real_A,real_B,warped_B,fake_A1,fake_A2,fake_B"
    _both(tmp_path, ["prep-crop", "--stack-dir", str(tmp_path / "stacks"), "--roles", roles],
          {"--out-root": "crops"})
    for role in roles.split(","):
        _assert_same_pngs(tmp_path / "port" / "crops" / role, tmp_path / "jax" / "crops" / role, 2)

    # noise and flat patches: gradients of every size, and ties
    _png_dir(tmp_path / "morph_in", [(20, 28, 3), (16, 16, 3)], seed=3)
    flat = np.zeros((12, 12, 3), np.uint8)
    flat[4:8, 4:8] = 200
    Image.fromarray(flat).save(tmp_path / "morph_in" / "flat.png")
    _both(tmp_path, ["prep-morphs", "--in-dir", str(tmp_path / "morph_in")],
          {"--out-dir": "morphs"})
    _assert_same_pngs(tmp_path / "port" / "morphs", tmp_path / "jax" / "morphs", 3)


def test_gallery_and_mesh_match_the_jax_cli(tmp_path):
    _png_dir(tmp_path / "samples", [(16, 48, 3)] * 3, seed=4)
    for side, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, ["--cpu"])):
        main(["gallery", "--dir", str(tmp_path / "samples"), "--title", "t", *device])
        os.replace(tmp_path / "samples" / "index.html", tmp_path / f"{side}.html")
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()

    refusals = []
    for side, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, ["--cpu"])):
        with pytest.raises(ImportError, match="mediapipe") as info:
            main(["mesh", "--src-dir", str(tmp_path / "samples"),
                  "--out-dir", str(tmp_path / side / "mesh"), *device])
        refusals.append(str(info.value))
    assert refusals[0] == refusals[1]
    assert not (tmp_path / "port" / "mesh").exists()


def test_mesh_draws_with_another_detector(tmp_path):
    """The drawing core and the directory loop without mediapipe, against
    the JAX module with the same detector."""
    from tfcgan_tpu.evaluation import face_mesh as jax_face_mesh
    from tfcgan_tpu_torch.evaluation import face_mesh

    _png_dir(tmp_path / "faces", [(32, 32, 3)] * 2, seed=5)
    (tmp_path / "faces" / "broken.png").write_bytes(b"not a png")

    def detector(image):  # a fixed "face": 4 points and their cycle
        pts = np.array([[4, 4], [27, 5], [26, 28], [5, 26]], np.float32)
        return pts, [(0, 1), (1, 2), (2, 3), (3, 0)]

    for side, module in (("port", face_mesh), ("jax", jax_face_mesh)):
        assert module.overlay_directory(str(tmp_path / "faces"), str(tmp_path / side),
                                        detector) == 2
    _assert_same_pngs(tmp_path / "port", tmp_path / "jax", 2)
    assert face_mesh.overlay_directory(str(tmp_path / "faces"), str(tmp_path / "none"),
                                       lambda image: None) == 0
