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

The debiased family: ``conditional_generator_from_flax`` (``label_fc`` and
the inner ``unet``), ``aux_discriminator_from_flax`` (the ``patch``
discriminator with its spectral u/v, and the label heads, whose Dense
kernels read the NHWC flatten of the input pair in both packages, so they
need no reordering) and ``resnet18_from_flax`` (both norm forms: a plain
tree of convs, norms and a Dense). ``regional_cnns_from_flax`` assembles the
two regional CNNs of a V4-V7 train state from its ``frozen`` backbones and,
for V4-V6, the heads in its ``g_params``.

ThermalGAN (``thermalgan_generators_from_flax``: G1, E, G2, whose up blocks
are transposed convs; ``thermalgan_discriminators_from_flax``: D_pix, D_vae,
the pyramid's ``disc_i`` included) and CycleGAN
(``cyclegan_generators_from_flax``, ``cyclegan_discriminators_from_flax``)
are trees of convs, norms and Dense layers; ``train_state_from_flax`` also
carries a state's ``frozen`` D_vae and its ``extra`` (the replay buffers and
counts, ``extra_from_flax``).

The bridge takes numpy-convertible leaves and never imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tfcgan_tpu_torch.train.state import TrainState, g_parameters, make_optimizers


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


def conditional_generator_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``ConditionalGeneratorUNet`` params ({"label_fc", "unet"}, nested
    or flat) -> float32 state dict of the port's conditional G."""
    flat = flatten_params(params)
    state = {"label_fc.weight": _dense(flat["label_fc/kernel"], 1),
             "label_fc.bias": _tensor(flat["label_fc/bias"])}
    unet = {k[len("unet/"):]: v for k, v in flat.items() if k.startswith("unet/")}
    if len(unet) + 2 != len(flat):
        raise KeyError(f"not a ConditionalGeneratorUNet tree: {sorted(flat)[:4]}...")
    state.update({f"unet.{k}": v for k, v in generator_from_flax(unet).items()})
    return state


def tfcgan_generator_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The G tree of a tfcgan train state, conditional or not."""
    if "label_fc/kernel" in flatten_params(params):
        return conditional_generator_from_flax(params)
    return generator_from_flax(params)


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


def aux_discriminator_from_flax(params: Mapping, spectral: Mapping | None = None
                               ) -> dict[str, torch.Tensor]:
    """JAX ``AuxClassifierDiscriminator`` params (and its ``spectral``
    collection) -> state dict of the port's: ``patch.*`` from
    ``discriminator_from_flax``, the heads ``aux_*`` Dense layers."""
    state = {f"patch.{k}": v for k, v in discriminator_from_flax(
        params["patch"], spectral["patch"] if spectral else None).items()}
    for head, leaves in params.items():
        if head == "patch":
            continue
        if not head.startswith("aux_"):
            raise KeyError(f"no AuxClassifierDiscriminator parameter {head!r}")
        state[f"{head}.weight"] = _dense(leaves["kernel"], 1)
        state[f"{head}.bias"] = _tensor(leaves["bias"])
    return state


def tfcgan_discriminator_from_flax(params: Mapping, spectral: Mapping | None = None
                                   ) -> dict[str, torch.Tensor]:
    """The D tree of a tfcgan train state, with or without label heads."""
    if "patch" in params:
        return aux_discriminator_from_flax(params, spectral)
    return discriminator_from_flax(params, spectral)


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
# and so are the diffusion U-Net, with its GroupNorm scales, and ResNet-18
cond_unet_from_flax = conv_net_from_flax
resnet18_from_flax = conv_net_from_flax

REGIONAL_CNNS = ("cnn_hair", "cnn_eyes")


def regional_cnns_from_flax(g_params: Mapping, frozen: Mapping) -> dict[str, torch.Tensor]:
    """The regional CNNs of a debiased V4-V7 train state -> state dict of the
    recipe's ``cnns``: V4-V6 keep the backbones in ``frozen["cnn_*_bb"]`` and
    the heads in ``g_params["cnn_*"]``, V7 both in ``frozen["cnn_*"]``."""
    state = {}
    for name in REGIONAL_CNNS:
        tree = {**frozen[f"{name}_bb"], **g_params[name]} if name in g_params else frozen[name]
        state.update({f"{name}.{k}": v for k, v in resnet18_from_flax(tree).items()})
    return state


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


def cyclegan_generators_from_flax(g_params: Mapping) -> dict[str, torch.Tensor]:
    """The cyclegan recipe's ``g_params`` {"G_AB", "G_BA"} (two ResNet
    generators) -> state dict of ``recipe.G``."""
    return _grouped(g_params)


def cyclegan_discriminators_from_flax(d_params: Mapping, spectral: Mapping | None = None
                                      ) -> dict[str, torch.Tensor]:
    """The cyclegan recipe's ``d_params`` {"D_A", "D_B"} -> state dict of
    ``recipe.D`` (no spectral norm)."""
    return _grouped(d_params)


def thermalgan_generators_from_flax(g_params: Mapping) -> dict[str, torch.Tensor]:
    """The thermalgan recipe's ``g_params`` {"G1", "E", "G2"} (nested, or flat
    with "/"-joined keys) -> state dict of ``recipe.G``. G2's up blocks are
    transposed convs, (kh, kw, in, out) -> torch's (in, out, kh, kw); every
    other leaf converts as a plain conv net (the Encoder's Dense kernels read
    the NHWC flatten in both packages, so they only transpose)."""
    flat = flatten_params(g_params)
    transposed = {k: v for k, v in flat.items()
                  if k.startswith("G2/up") and k.endswith("/conv/kernel")}
    state = _grouped({k: v for k, v in flat.items() if k not in transposed})
    state.update({k[:-len("kernel")].replace("/", ".") + "weight": _tensor(v, (2, 3, 0, 1))
                  for k, v in transposed.items()})
    return state


def thermalgan_discriminators_from_flax(d_params: Mapping, spectral: Mapping | None = None
                                        ) -> dict[str, torch.Tensor]:
    """The thermalgan recipe's ``d_params`` {"D_pix"[, "D_vae"]} (or its
    ``frozen`` {"D_vae"}) -> state dict of ``recipe.D`` (or ``recipe.frozen``)."""
    return _grouped(d_params)


def extra_from_flax(extra, device) -> dict | None:
    """A JAX state's recipe-owned ``extra`` (nested dicts of arrays) -> the
    same nesting of tensors on ``device``: float arrays as float32, integer
    ones (the replay buffers' counts) as int64."""
    if extra is None:
        return None
    if isinstance(extra, Mapping):
        return {k: extra_from_flax(v, device) for k, v in extra.items()}
    arr = np.asarray(extra)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(arr, dtype=torch.int64, device=device)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def _load_adam(opt: torch.optim.Adam, named: Mapping[str, torch.nn.Parameter], adam_state,
               to_state_dict) -> None:
    """optax ``ScaleByAdamState`` (count, mu, nu) -> the torch Adam's state;
    ``to_state_dict`` maps a moment tree to tensors under ``named``'s names."""
    count = int(np.asarray(adam_state.count))
    if count == 0:
        return
    mu, nu = to_state_dict(adam_state.mu), to_state_dict(adam_state.nu)
    for name, p in named.items():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].to(p.device), "exp_avg_sq": nu[name].to(p.device)}


def train_state_from_flax(state, recipe, generator: torch.Generator):
    """A JAX ``GANTrainState`` of any recipe (the tfcgan, conditional or not,
    stn, nemar, diffusion, cyclegan or thermalgan) -> a port ``TrainState``
    over ``recipe``'s modules: weights, spectral u/v, LPIPS, the regional CNNs,
    the frozen modules (ThermalGAN's detached D_vae), the recipe-owned
    ``extra`` (CycleGAN's replay buffers and counts),
    the Adams' moments and counts (one Adam for the diffusion recipe, whose D
    side is empty; G's covers the V4-V6 regional heads), and the step (which
    fixes the schedule's learning rate). Draws come from ``generator``."""
    if recipe.name == "diffusion":
        g_from_flax = diffusion_generators_from_flax

        def d_from_flax(tree, spectral=None):
            return {}
    elif recipe.name == "stn":
        g_from_flax, d_from_flax = stn_generators_from_flax, stn_discriminators_from_flax
    elif recipe.name == "nemar":
        g_from_flax, d_from_flax = nemar_generators_from_flax, nemar_discriminators_from_flax
    elif recipe.name == "cyclegan":
        g_from_flax, d_from_flax = cyclegan_generators_from_flax, cyclegan_discriminators_from_flax
    elif recipe.name == "thermalgan":
        g_from_flax = thermalgan_generators_from_flax
        d_from_flax = thermalgan_discriminators_from_flax
    else:
        def g_from_flax(tree):
            return tfcgan_generator_from_flax(tree["G"])

        def d_from_flax(tree, spectral=None):
            return tfcgan_discriminator_from_flax(tree["D"], spectral["D"] if spectral else None)
    cnns = getattr(recipe, "cnns", None)

    def g_moments(tree):  # the G Adam's names: G's, and the V4-V6 heads in the tree
        heads = {f"cnns.{name}.{k}": v for name in REGIONAL_CNNS if name in tree
                 for k, v in resnet18_from_flax(tree[name]).items()}
        return {**{f"G.{k}": v for k, v in g_from_flax(tree).items()}, **heads}

    recipe.G.load_state_dict(g_from_flax(state.g_params))
    recipe.D.load_state_dict(d_from_flax(state.d_params, state.spectral))
    if recipe.lpips is not None:
        recipe.lpips.load_state_dict(lpips_from_flax(state.frozen["lpips"]))
    if cnns is not None:
        cnns.load_state_dict(regional_cnns_from_flax(state.g_params, state.frozen))
    frozen = getattr(recipe, "frozen", None)
    if frozen is not None:  # ThermalGAN's detached D_vae
        frozen.load_state_dict(thermalgan_discriminators_from_flax(state.frozen))
    step = int(np.asarray(state.step))
    opt_g, opt_d = make_optimizers(recipe.cfg, recipe, step)
    _load_adam(opt_g, g_parameters(recipe), state.g_opt_state[0], g_moments)
    if opt_d is not None:
        _load_adam(opt_d, dict(recipe.D.named_parameters()), state.d_opt_state[0], d_from_flax)
    return TrainState(step=step, generator=generator, G=recipe.G, D=recipe.D,
                      lpips=recipe.lpips, opt_g=opt_g, opt_d=opt_d, cnns=cnns, frozen=frozen,
                      extra=extra_from_flax(getattr(state, "extra", None), recipe.device))


def load_generator_npz(path: str) -> dict[str, torch.Tensor]:
    """``g_params.npz`` of a tfcgan experiment (from
    ``tools/export_g_params.py``) -> state dict of its G, the conditional
    one's for a debiased experiment."""
    with np.load(path) as npz:
        return tfcgan_generator_from_flax({k: npz[k] for k in npz.files})


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


def load_cyclegan_generators_npz(path: str) -> dict[str, torch.Tensor]:
    """The cyclegan recipe's ``g_params.npz`` (G_AB and G_BA, from
    ``tools/export_g_params.py``) -> state dict of ``recipes.cyclegan.build_generators``."""
    with np.load(path) as npz:
        return cyclegan_generators_from_flax({k: npz[k] for k in npz.files})


def load_thermalgan_generators_npz(path: str) -> dict[str, torch.Tensor]:
    """The thermalgan recipe's ``g_params.npz`` (G1, E and G2, from
    ``tools/export_g_params.py``) -> state dict of ``recipes.thermalgan.build_generators``."""
    with np.load(path) as npz:
        return thermalgan_generators_from_flax({k: npz[k] for k in npz.files})
