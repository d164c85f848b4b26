"""The port's own config registry against the JAX package's, entry by entry
(the port's import with JAX and the JAX package blocked is in
test_torch_serve.py), and the packaging of the CUDA sources."""

import dataclasses
import os

import pytest

import tfcgan_tpu.config as jax_config
import tfcgan_tpu_torch.config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_registries_hold_the_same_names():
    assert sorted(port_config.EXPERIMENTS) == sorted(jax_config.EXPERIMENTS)
    assert len(port_config.EXPERIMENTS) >= 30


@pytest.mark.parametrize("name", sorted(jax_config.EXPERIMENTS))
def test_registry_entry_equals_the_jax_entry(name):
    got, want = port_config.get_experiment(name), jax_config.get_experiment(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the copy is a copy: its classes are the port's own
    assert type(got) is port_config.ExperimentConfig
    assert type(got) is not type(want)


def test_dataclass_defaults_and_register_equal():
    for cls in ("OptimConfig", "DataConfig", "LossConfig", "TrainConfig", "MeshConfig",
                "ExperimentConfig"):
        assert dataclasses.asdict(getattr(port_config, cls)()) == \
            dataclasses.asdict(getattr(jax_config, cls)()), cls
    with pytest.raises(KeyError, match="unknown experiment"):
        port_config.get_experiment("no_such_experiment")
    cfg = port_config.ExperimentConfig(name="_test_entry")
    try:
        assert port_config.register(cfg) is cfg
        assert port_config.get_experiment("_test_entry") is cfg
        assert "_test_entry" not in jax_config.EXPERIMENTS
    finally:
        del port_config.EXPERIMENTS["_test_entry"]


def test_resample_source_ships_with_the_package():
    """``csrc/*.cu`` is package data (pyproject.toml) and the build directory
    is ignored by git."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["tfcgan_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cpp" in data and "evaluation/*.npz" in data
    csrc = os.path.join(REPO, "tfcgan_tpu_torch", "csrc")
    assert sorted(os.listdir(csrc)) == ["blurpool.cu", "fastpair.cpp", "flashattn.cu",
                                        "gridsample.cu", "resample.cu"]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "tfcgan_tpu_torch/_build/" in f.read().split()
    from tfcgan_tpu_torch.ops.kernels import _build

    assert _build.library_path("resample").parent == _build.BUILD_DIR
    src = open(os.path.join(csrc, "resample.cu")).read()
    for symbol in ("tfcgan_resample_fwd", "tfcgan_resample_adjoint", "tfcgan_resample_gradpos"):
        assert f'extern "C" int {symbol}(' in src
    assert "atomicAdd" not in src
    src = open(os.path.join(csrc, "flashattn.cu")).read()
    for symbol in ("tfcgan_flashattn_fwd", "tfcgan_flashattn_bwd_dq", "tfcgan_flashattn_bwd_dkv"):
        assert f'extern "C" int {symbol}(' in src
    assert "atomicAdd" not in src and "__expf" not in src
