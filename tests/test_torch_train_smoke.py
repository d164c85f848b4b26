"""``tools/train_smoke_torch.py`` against ``tools/train_smoke_tpu.py``, on the CPU.

The JAX tool trains at import, so its ``SIZE``, ``B`` and ``make_batch`` are
taken from its source (``ast``) and run alone. The port's batches equal them
bit for bit; the port's PSNR (``ops.metrics.psnr``) equals the JAX
``ops.psnr`` on the same arrays; and the tool's loop runs 2 steps at 64²,
B=2 on the host (the plain path: no kernel launched). About 8 s.
"""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

from tfcgan_tpu import ops as jax_ops
from tfcgan_tpu_torch.ops.metrics import psnr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tool_batch_maker():
    """The JAX tool's ``SIZE``, ``B`` and ``make_batch``, without its run."""
    with open(os.path.join(ROOT, "tools", "train_smoke_tpu.py")) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "make_batch")
            or (isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Tuple) and {e.id for e in t.elts} == {"SIZE", "B"}
                for t in n.targets))]
    assert len(keep) == 2
    space = {"np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "train_smoke_tpu.py", "exec"), space)
    return space


@pytest.fixture(scope="module")
def tool():
    return _load("train_smoke_torch")


@pytest.mark.parametrize("seed", [0, 49, 999])
def test_batches_equal_the_jax_tool(tool, seed):
    jax_tool = _jax_tool_batch_maker()
    assert (tool.SIZE, tool.B) == (jax_tool["SIZE"], jax_tool["B"])
    want = jax_tool["make_batch"](seed)
    got = tool.make_batch(seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_psnr_equals_the_jax_psnr(tool):
    b = tool.make_batch(7, 64, 4)
    real = (b["B"] * 0.5 + 0.5) * 255.0
    fake = (np.tanh(b["B"] + 0.1 * np.random.RandomState(1).randn(*b["B"].shape))
            .astype(np.float32) * 0.5 + 0.5) * 255.0
    fake[0] = real[0]  # mse 0: both give 100
    want = np.asarray(jax_ops.psnr(real, fake))
    got = psnr(torch.from_numpy(real), torch.from_numpy(fake)).numpy()
    assert want[0] == got[0] == 100.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_the_loop_runs_on_the_host(tool):
    out = tool.run("cpu", steps=2, size=64, batch=2, log=lambda msg: None)
    assert np.isfinite(out["psnr_before"]) and np.isfinite(out["psnr_after"])
    assert out["psnr_after"] != out["psnr_before"]
    assert out["k1_step"] == {"fwd": 0, "bwd": 0} and out["k1_eval"] == {"fwd": 0, "bwd": 0}
