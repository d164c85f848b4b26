"""``tools/make_e2e_dataset_torch.py`` against the JAX package's
``tools/make_e2e_dataset.py``: the same file names and the same PNG bytes
for each scene, with and without the misregistered B. The JAX tool runs as
a subprocess on the CPU (``JAX_PLATFORMS=cpu``), the port's in this process.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n", "6", "--test", "3", "--size", "64"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_e2e_dataset_torch", os.path.join(REPO, "tools", "make_e2e_dataset_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("args", [
    [],
    ["--scene", "face"],
    ["--scene", "face", "--warp-b"],
    ["--warp-b", "--seed", "3"],
], ids=["blocks", "face", "face-warp-b", "blocks-warp-b-seed3"])
def test_same_files_and_bytes_as_jax(tmp_path, args):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    _tool().main(["--root", port_root, *SMALL, *args])
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_e2e_dataset.py"),
                    "--root", jax_root, *SMALL, *args], check=True, env=env, cwd=REPO,
                   capture_output=True, timeout=120)
    got, want = _files(port_root), _files(jax_root)
    dirs = {"train", "test"} | ({"test_aligned_B"} if "--warp-b" in args else set())
    assert {os.path.dirname(k) for k in want} == dirs
    assert len([k for k in want if k.startswith("train")]) == 6
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
