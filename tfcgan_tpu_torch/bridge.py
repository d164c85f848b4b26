"""Weights and train states from the JAX package to the port.

``generator_from_flax`` turns the JAX ``params["G"]`` tree of
``GeneratorUNet`` (a nested dict, or a flat dict with "/"-joined keys as
``tools/export_g_params.py`` writes to ``g_params.npz``) into the state dict of
``tfcgan_tpu_torch.models.unet.GeneratorUNet``; ``discriminator_from_flax``
and ``lpips_from_flax`` do the same for ``PatchDiscriminator`` (with its
spectral u/v), ``LPIPS``, ``ViT`` (``vit_from_flax``) and the affine STN
(``stn_from_flax``), and ``train_state_from_flax`` for a whole
``GANTrainState`` of the tfcgan, the stn, the nemar or the diffusion recipe
(one Adam: the family has no discriminator). The TFC-Diff networks come over
with ``cond_unet_from_flax`` and ``diffusion_generators_from_flax`` (``unet``,
``class_emb``, ``G``). NeMAR's networks
(``resnet_generator_from_flax``, ``deformable_stn_from_flax``,
``cnn_affine_stn_from_flax``, ``nlayer_discriminator_from_flax``,
``pixel_discriminator_from_flax``) are plain trees of convs and Dense layers
and share one conversion. Flax stores every conv kernel as
``(kh, kw, in, out)``; torch wants ``(out, in, kh, kw)`` for a conv and
``(in, out, kh, kw)`` for a transposed conv (the up blocks' ``conv``). The
spectral v is W's right singular vector over W flattened as (kh, kw, in) in
flax and as (in, kh, kw) in torch, so it is reordered. A flax ``Dense`` kernel
is ``(in, out)`` and torch's ``(out, in)``; the attention's q/k/v kernels are
``(dim, heads, head_dim)`` and its out kernel ``(heads, head_dim, dim)``, both
flattened to ``(dim, dim)`` before the transpose.

The bridge takes numpy-convertible leaves and never imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tfcgan_tpu_torch.train.state import TrainState, make_optimizers


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/c": np.ndarray}; flat input passes through."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _generator_key(path: str) -> tuple[str, tuple[int, ...] | None]:
    """Flax path -> (torch state-dict key, axis order for np.transpose)."""
    parts = path.split("/")
    if len(parts) == 3 and parts[1] == "conv" and parts[2] == "kernel":
        if parts[0].startswith("down"):
            return f"{parts[0]}.conv.weight", (3, 2, 0, 1)
        if parts[0].startswith("up"):
            return f"{parts[0]}.conv.weight", (2, 3, 0, 1)
    if parts == ["final_conv", "kernel"]:
        return "final_conv.weight", (3, 2, 0, 1)
    if parts == ["final_conv", "bias"]:
        return "final_conv.bias", None
    raise KeyError(f"no GeneratorUNet parameter for flax path {path!r}")


def _tensor(value, axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """A float32 tensor that owns a copy of ``value`` (JAX arrays read as
    read-only numpy), its axes in the order ``axes``."""
    arr = np.asarray(value, dtype=np.float32)
    if axes is not None:
        arr = arr.transpose(axes)
    return torch.from_numpy(np.array(arr, order="C"))


def generator_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``GeneratorUNet`` params -> float32 state dict of the port's G."""
    state = {}
    for path, value in flatten_params(params).items():
        key, axes = _generator_key(path)
        state[key] = _tensor(value, axes)
    return state


def discriminator_from_flax(params: Mapping, spectral: Mapping | None = None
                            ) -> dict[str, torch.Tensor]:
    """JAX ``PatchDiscriminator`` params (and its ``spectral`` collection, for
    the u/v buffers) -> state dict of the port's D. Without ``spectral`` only
    the parameters come over (as for optimizer moments)."""
    state = {}
    for path, value in flatten_params(params).items():
        module, leaf = path.split("/")
        if leaf == "kernel":
            state[f"{module}.weight"] = _tensor(value, (3, 2, 0, 1))
        elif leaf == "bias":
            state[f"{module}.bias"] = _tensor(value)
        else:
            raise KeyError(f"no PatchDiscriminator parameter for flax path {path!r}")
    for module, uv in (spectral or {}).items():
        kh, kw, cin, _ = np.shape(params[module]["kernel"])
        state[f"{module}.u"] = _tensor(uv["u"])
        state[f"{module}.v"] = _tensor(np.asarray(uv["v"]).reshape(kh, kw, cin), (2, 0, 1)
                                       ).reshape(-1)
    return state


def lpips_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``LPIPS`` variables ({"params": ...}, or the params alone) ->
    state dict of the port's LPIPS."""
    params = variables.get("params", variables)
    state = {}
    for path, value in flatten_params(params).items():
        parts = path.split("/")
        if parts[0] == "vgg" and parts[2] == "kernel":
            state[f"vgg.{parts[1]}.weight"] = _tensor(value, (3, 2, 0, 1))
        elif parts[0] == "vgg" and parts[2] == "bias":
            state[f"vgg.{parts[1]}.bias"] = _tensor(value)
        elif len(parts) == 1 and parts[0].startswith("lin"):
            state[parts[0]] = _tensor(value)
        else:
            raise KeyError(f"no LPIPS parameter for flax path {path!r}")
    return state


def _dense(kernel, in_axes: int) -> torch.Tensor:
    """A flax Dense/DenseGeneral kernel, its first ``in_axes`` axes the input,
    -> torch's (out, in) weight."""
    k = np.asarray(kernel, dtype=np.float32)
    return _tensor(k.reshape(int(np.prod(k.shape[:in_axes])), -1), (1, 0))


def vit_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``ViT`` params -> state dict of the port's ``models.vit.ViT``."""
    state = {}
    for path, value in flatten_params(params).items():
        parts = path.split("/")
        leaf = parts[-1]
        if parts[0].startswith("block"):
            prefix = f"blocks.{int(parts[0][5:])}." + ".".join(parts[1:-1])
        else:
            prefix = ".".join(parts[:-1])
        if path in ("cls_token", "pos_embed"):
            state[path] = _tensor(value)
        elif parts[0] == "patch_embed" and leaf == "kernel":
            state["patch_embed.weight"] = _tensor(value, (3, 2, 0, 1))
        elif leaf == "kernel":  # the out projection's input is (heads, head_dim)
            state[f"{prefix}.weight"] = _dense(value, 2 if parts[-2] == "out" else 1)
        elif leaf == "scale":
            state[f"{prefix}.weight"] = _tensor(value)
        elif leaf == "bias":
            state[f"{prefix}.bias"] = _tensor(value).reshape(-1)
        else:
            raise KeyError(f"no ViT parameter for flax path {path!r}")
    return state


def stn_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX affine-STN params (``AffineSTN``: the ViT under
    ``localization/vit``; the recipe's ``_STNNet``: under ``vit``) -> state
    dict of the port's ``models.stn.AffineSTN``."""
    flat = flatten_params(params)
    vit, state = {}, {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "localization":
            parts = parts[1:]
        if parts[0] == "vit":
            vit["/".join(parts[1:])] = value
        elif len(parts) == 2 and parts[0] in ("fc1", "fc2", "fc3", "fc4"):
            if parts[1] == "kernel":
                state[f"{parts[0]}.weight"] = _dense(value, 1)
            else:
                state[f"{parts[0]}.bias"] = _tensor(value)
        else:
            raise KeyError(f"no AffineSTN parameter for flax path {path!r}")
    state.update({f"vit.{k}": v for k, v in vit_from_flax(vit).items()})
    return state


def stn_generators_from_flax(g_params: Mapping) -> dict[str, torch.Tensor]:
    """The stn recipe's ``g_params`` {"G1", "G2", "STN"} (nested, or flat with
    "/"-joined keys) -> state dict of the port's ``recipe.G`` container."""
    groups: dict[str, dict] = {"G1": {}, "G2": {}, "STN": {}}
    for path, value in flatten_params(g_params).items():
        head, rest = path.split("/", 1)
        groups[head][rest] = value
    state = {}
    for name, convert in (("G1", generator_from_flax), ("G2", generator_from_flax),
                          ("STN", stn_from_flax)):
        state.update({f"{name}.{k}": v for k, v in convert(groups[name]).items()})
    return state


def stn_discriminators_from_flax(d_params: Mapping, spectral: Mapping | None = None
                                 ) -> dict[str, torch.Tensor]:
    """The stn recipe's ``d_params`` {"D1", "D2"} (and their ``spectral``
    collections) -> state dict of the port's ``recipe.D`` container."""
    state = {}
    for name in ("D1", "D2"):
        head = discriminator_from_flax(d_params[name], spectral[name] if spectral else None)
        state.update({f"{name}.{k}": v for k, v in head.items()})
    return state


def conv_net_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX module tree of plain convs and Dense layers (nested, or flat with
    "/"-joined keys) -> the state dict of its port, whose modules carry the
    same names: ``a/b/kernel`` becomes ``a.b.weight``, a 4-D kernel in torch's
    conv layout and a 2-D one transposed; ``a/b/bias`` becomes ``a.b.bias``; a
    norm's ``a/b/scale`` becomes ``a.b.weight``.
    (The conv-affine STN's first Dense reads an NHWC flatten in both packages,
    so its kernel needs no reordering.)"""
    state = {}
    for path, value in flatten_params(params).items():
        module, _, leaf = path.rpartition("/")
        key = module.replace("/", ".")
        if leaf == "bias":
            state[f"{key}.bias"] = _tensor(value)
        elif leaf == "kernel" and np.ndim(value) == 4:
            state[f"{key}.weight"] = _tensor(value, (3, 2, 0, 1))
        elif leaf == "kernel" and np.ndim(value) == 2:
            state[f"{key}.weight"] = _dense(value, 1)
        elif leaf == "scale":
            state[f"{key}.weight"] = _tensor(value)
        else:
            raise KeyError(f"no conv or Dense parameter for flax path {path!r}")
    return state


# each of NeMAR's networks is such a tree
resnet_generator_from_flax = conv_net_from_flax
deformable_stn_from_flax = conv_net_from_flax
cnn_affine_stn_from_flax = conv_net_from_flax
nlayer_discriminator_from_flax = conv_net_from_flax
pixel_discriminator_from_flax = conv_net_from_flax
# and so is the diffusion U-Net, with its GroupNorm scales
cond_unet_from_flax = conv_net_from_flax


def _grouped(tree: Mapping) -> dict[str, torch.Tensor]:
    """A tree of named conv nets ({"T", "R"} or {"D", "D_mr0", ...}, nested
    or flat) -> the state dict of the ``nn.ModuleDict`` that holds them."""
    groups: dict[str, dict] = {}
    for path, value in flatten_params(tree).items():
        head, rest = path.split("/", 1)
        groups.setdefault(head, {})[rest] = value
    return {f"{name}.{k}": v for name, group in groups.items()
            for k, v in conv_net_from_flax(group).items()}


def nemar_generators_from_flax(g_params: Mapping) -> dict[str, torch.Tensor]:
    """The nemar recipe's ``g_params`` {"T", "R"} -> state dict of ``recipe.G``."""
    return _grouped(g_params)


def nemar_discriminators_from_flax(d_params: Mapping, spectral: Mapping | None = None
                                   ) -> dict[str, torch.Tensor]:
    """The nemar recipe's ``d_params`` {"D", "D_mr{i}"} -> state dict of
    ``recipe.D``. ``spectral`` is the train state's collection, empty for
    NeMAR: its discriminators carry no spectral norm."""
    return _grouped(d_params)


def diffusion_generators_from_flax(g_params: Mapping) -> dict[str, torch.Tensor]:
    """The diffusion recipe's ``g_params`` {"unet"[, "class_emb"][, "G"]}
    (nested, or flat with "/"-joined keys) -> state dict of the port's
    ``recipes.diffusion.DiffusionGenerators``."""
    groups: dict[str, dict] = {"unet": {}, "G": {}}
    state = {}
    for path, value in flatten_params(g_params).items():
        if path == "class_emb":
            state["class_emb"] = _tensor(value)
        else:
            head, rest = path.split("/", 1)
            groups[head][rest] = value
    state.update({f"unet.{k}": v for k, v in cond_unet_from_flax(groups["unet"]).items()})
    state.update({f"G.{k}": v for k, v in generator_from_flax(groups["G"]).items()})
    return state


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module, adam_state,
               to_state_dict) -> None:
    """optax ``ScaleByAdamState`` (count, mu, nu) -> the torch Adam's state."""
    count = int(np.asarray(adam_state.count))
    if count == 0:
        return
    mu, nu = to_state_dict(adam_state.mu), to_state_dict(adam_state.nu)
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].to(p.device), "exp_avg_sq": nu[name].to(p.device)}


def train_state_from_flax(state, recipe, generator: torch.Generator):
    """A JAX ``GANTrainState`` of the tfcgan, the stn, the nemar or the
    diffusion recipe -> a port ``TrainState`` over ``recipe``'s modules:
    weights, spectral u/v, LPIPS, the Adams' moments and counts (one Adam for
    the diffusion recipe, whose D side is empty), and the step (which fixes
    the schedule's learning rate). Draws come from ``generator``."""
    if recipe.name == "diffusion":
        g_from_flax = diffusion_generators_from_flax

        def d_from_flax(tree, spectral=None):
            return {}
    elif recipe.name == "stn":
        g_from_flax, d_from_flax = stn_generators_from_flax, stn_discriminators_from_flax
    elif recipe.name == "nemar":
        g_from_flax, d_from_flax = nemar_generators_from_flax, nemar_discriminators_from_flax
    else:
        def g_from_flax(tree):
            return generator_from_flax(tree["G"])

        def d_from_flax(tree, spectral=None):
            return discriminator_from_flax(tree["D"], spectral["D"] if spectral else None)
    recipe.G.load_state_dict(g_from_flax(state.g_params))
    recipe.D.load_state_dict(d_from_flax(state.d_params, state.spectral))
    if recipe.lpips is not None:
        recipe.lpips.load_state_dict(lpips_from_flax(state.frozen["lpips"]))
    step = int(np.asarray(state.step))
    opt_g, opt_d = make_optimizers(recipe.cfg, recipe, step)
    _load_adam(opt_g, recipe.G, state.g_opt_state[0], g_from_flax)
    if opt_d is not None:
        _load_adam(opt_d, recipe.D, state.d_opt_state[0], d_from_flax)
    return TrainState(step=step, generator=generator, G=recipe.G,
                      D=recipe.D, lpips=recipe.lpips, opt_g=opt_g, opt_d=opt_d)


def load_generator_npz(path: str) -> dict[str, torch.Tensor]:
    """``g_params.npz`` (from ``tools/export_g_params.py``) -> state dict."""
    with np.load(path) as npz:
        return generator_from_flax({k: npz[k] for k in npz.files})


def load_stn_generators_npz(path: str) -> dict[str, torch.Tensor]:
    """The stn recipe's ``g_params.npz`` (G1, G2 and STN, from
    ``tools/export_g_params.py``) -> state dict of ``recipes.stn.build_generators``."""
    with np.load(path) as npz:
        return stn_generators_from_flax({k: npz[k] for k in npz.files})


def load_nemar_generators_npz(path: str) -> dict[str, torch.Tensor]:
    """The nemar recipe's ``g_params.npz`` (T and R, from
    ``tools/export_g_params.py``) -> state dict of ``recipes.nemar.build_generators``."""
    with np.load(path) as npz:
        return nemar_generators_from_flax({k: npz[k] for k in npz.files})


def load_diffusion_generators_npz(path: str) -> dict[str, torch.Tensor]:
    """The diffusion recipe's ``g_params.npz`` (unet, and where the variant has
    them class_emb and G, from ``tools/export_g_params.py``) -> state dict of
    ``recipes.diffusion.build_generators``."""
    with np.load(path) as npz:
        return diffusion_generators_from_flax({k: npz[k] for k in npz.files})
