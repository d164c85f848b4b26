"""The STN family's building blocks of the port against the JAX modules:
morphology, the msrecon anchor, the ViT and the affine STN, float32 on the
CPU, the same numpy inputs and the JAX weights carried over by the bridge.

Tolerances: morphology and msrecon are a few float32 operations (atol 1e-6 /
rtol 1e-5); ViT tokens atol 2e-5 (LayerNorm + matmuls through 2 blocks), in
bfloat16 a relative L2 of 2e-2 against JAX's bfloat16 tokens (each side's
rounding: about 5e-3 from JAX's float32 ones);
theta atol 2e-5, warped images 5e-5 (theta's own 1e-5 moves a sample by up to
3e-4 pixel at 64², times the image's slope; with one theta both warps agree to
2e-5, test_torch_resample.py and test_torch_warp.py); parameter gradients atol 2e-4 x the tensor's
max|g| plus 1e-7 (but the attention's key bias, whose gradient is exactly zero,
softmax being shift-invariant: there both sides return rounding noise, held
below 1e-5 x the largest gradient). Morphology inputs are continuous random values: at a tie the
max's gradient goes to one of the tied pixels and the frameworks may differ in
which, so only tie-free inputs are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.models.stn import AffineSTN as JaxAffineSTN
from tfcgan_tpu.models.vit import ViT as JaxViT
from tfcgan_tpu.ops import morphology as jax_morphology
from tfcgan_tpu.ops import perceptual as jax_perceptual
from tfcgan_tpu.recipes.stn import _STNNet as JaxSTNNet
from tfcgan_tpu.recipes.stn import morph_triplet as jax_morph_triplet
from tfcgan_tpu_torch.bridge import flatten_params, stn_from_flax, vit_from_flax
from tfcgan_tpu_torch.config import get_experiment
from tfcgan_tpu_torch.models.stn import IDENTITY_THETA, AffineSTN, LocalizerViT, warp_src
from tfcgan_tpu_torch.models.vit import ViT
from tfcgan_tpu_torch.ops import morphology, perceptual
from tfcgan_tpu_torch.recipes.stn import _STNNet, morph_triplet

SMALL = dict(depth=2, dim=96, heads=4, mlp_dim=192)


def _np_params(shapes, seed, scale=0.05):
    """Random float32 leaves for a flax shape tree: normal(0, scale) kernels
    and embeddings, small non-zero biases, LayerNorm scales near 1."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if "bias" in name:
            return (0.02 * rng.randn(*s.shape)).astype(np.float32)
        return (scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _assert_grads(module, want_flat, convert):
    want = convert(want_flat)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in module.named_parameters():
        w = want[name].numpy()
        if name.endswith("attn.key.bias"):
            # exactly zero in exact arithmetic (softmax is shift-invariant):
            # both sides return rounding noise, which has nothing to agree on
            assert max(np.abs(w).max(), float(p.grad.abs().max())) < 1e-5 * largest, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=name)


# ------------------------------------------------------------ plain ops
def test_morphology_and_gradient():
    r = np.random.RandomState(0)
    x = r.randn(2, 9, 11, 3).astype(np.float32)  # continuous: no ties
    ct = r.randn(*x.shape).astype(np.float32)
    for fn in ("gray_dilation", "gray_erosion", "morphological_gradient"):
        want = np.asarray(getattr(jax_morphology, fn)(jnp.asarray(x)))
        want_g = jax.grad(lambda v: jnp.sum(getattr(jax_morphology, fn)(v) * ct))(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        got = getattr(morphology, fn)(tx)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, err_msg=fn)
        (got * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g), atol=1e-6, err_msg=fn)


def test_morph_triplet_and_gradient_to_the_warped_image():
    r = np.random.RandomState(1)
    a, b, w = (r.rand(2, 16, 16, 3).astype(np.float32) for _ in range(3))
    want = float(jax_morph_triplet(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
    want_g = jax.grad(lambda v: jax_morph_triplet(jnp.asarray(a), jnp.asarray(b), v))(
        jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    got = morph_triplet(torch.from_numpy(a), torch.from_numpy(b), tw)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_g),
                               atol=1e-5 * np.abs(want_g).max())


def test_ncc_and_multiscale_recon():
    r = np.random.RandomState(2)
    x = np.tanh(r.randn(2, 32, 32, 3)).astype(np.float32)
    y = np.tanh(x + 0.3 * r.randn(*x.shape)).astype(np.float32)
    np.testing.assert_allclose(
        perceptual.ncc_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jax_perceptual.ncc_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
    want = float(jax_perceptual.multiscale_recon(jnp.asarray(x), jnp.asarray(y)))
    want_g = jax.grad(lambda v: jax_perceptual.multiscale_recon(v, jnp.asarray(y)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = perceptual.multiscale_recon(tx, torch.from_numpy(y))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               atol=2e-5 * np.abs(want_g).max())
    # a constant image: the eps guard keeps NCC finite
    flat = torch.zeros(1, 8, 8, 3)
    assert float(perceptual.ncc_loss(flat, flat)) == 0.0


# ------------------------------------------------------------------ ViT
@pytest.mark.parametrize("patch,size", [(64, 128), (16, 64)])
def test_vit_matches_jax_with_bridged_weights(patch, size):
    jax_vit = JaxViT(patch_size=patch, dim=SMALL["dim"], depth=SMALL["depth"],
                     heads=SMALL["heads"], mlp_dim=SMALL["mlp_dim"])
    r = np.random.RandomState(3)
    x = np.tanh(r.randn(2, size, size, 6)).astype(np.float32)
    shapes = jax.eval_shape(jax_vit.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _np_params(shapes, seed=4)
    tokens = (size // patch) ** 2 + 1
    ct = r.randn(2, tokens, SMALL["dim"]).astype(np.float32)

    def loss(p):
        return jnp.sum(jax_vit.apply({"params": p}, jnp.asarray(x)) * ct)

    want = np.asarray(jax_vit.apply({"params": params}, jnp.asarray(x)))
    want_g = jax.jit(jax.grad(loss))(params)

    vit = ViT(size, in_channels=6, patch_size=patch, **SMALL)
    assert set(vit.state_dict()) == set(vit_from_flax(params))
    vit.load_state_dict(vit_from_flax(params))
    got = vit(torch.from_numpy(x))
    assert got.shape == (2, tokens, SMALL["dim"])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    (got * torch.from_numpy(ct)).sum().backward()
    _assert_grads(vit, want_g, vit_from_flax)


@pytest.mark.parametrize("patch,size", [(64, 128), (16, 64)])
def test_vit_in_bfloat16_matches_jax(patch, size):
    """The bfloat16 tokens against the JAX ViT's in bfloat16 on the same
    weights and input: 5.6e-3 and 5.4e-3 (JAX's bfloat16 tokens are 5.9e-3
    and 5.6e-3 from its float32 ones). The patch embedding as a bfloat16
    conv on the CPU put them 1.32 and 1.38 off."""
    jax_vit = JaxViT(patch_size=patch, dim=SMALL["dim"], depth=SMALL["depth"],
                     heads=SMALL["heads"], mlp_dim=SMALL["mlp_dim"], dtype=jnp.bfloat16)
    x = np.tanh(np.random.RandomState(3).randn(2, size, size, 6)).astype(np.float32)
    shapes = jax.eval_shape(jax_vit.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _np_params(shapes, seed=4)
    want = np.asarray(jax_vit.apply({"params": params}, jnp.asarray(x)), np.float32)
    vit = ViT(size, in_channels=6, patch_size=patch, dtype=torch.bfloat16, **SMALL)
    vit.load_state_dict(vit_from_flax(params))
    with torch.no_grad():
        got = vit(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def test_vit_refuses_another_image_size():
    vit = ViT(64, in_channels=6, patch_size=16, **SMALL)
    with pytest.raises(ValueError, match="patches"):
        vit(torch.zeros(1, 32, 32, 6))


def test_vit_init_follows_flax():
    vit = ViT(64, in_channels=6, patch_size=16, generator=torch.Generator().manual_seed(0),
              **SMALL)
    w = vit.blocks[0].mlp1.weight.detach()
    std = (1.0 / SMALL["dim"]) ** 0.5
    np.testing.assert_allclose(float(w.std()), std, rtol=0.05)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert not vit.cls_token.any() and not vit.blocks[0].mlp1.bias.any()
    np.testing.assert_allclose(float(vit.pos_embed.std()), 0.02, rtol=0.1)
    assert bool((vit.norm.weight == 1).all())


# ------------------------------------------------------------ AffineSTN
def _stn_pair(fast_warp, identity_init, seed=5, size=64):
    """The JAX recipe's _STNNet and the port's with the same weights (fc4 as
    the init says: zero under identity_init, else random)."""
    jax_stn = JaxSTNNet(patch=16, vit_depth=SMALL["depth"], vit_dim=SMALL["dim"],
                        vit_heads=SMALL["heads"], vit_mlp=SMALL["mlp_dim"],
                        fast_warp=fast_warp, identity_init=identity_init)
    img = jnp.zeros((2, size, size, 3))
    shapes = jax.eval_shape(jax_stn.init, jax.random.PRNGKey(0), img, img, img)["params"]
    params = _np_params(shapes, seed)
    if identity_init:
        params["fc4"] = jax.tree.map(np.zeros_like, params["fc4"])
    else:  # dtheta of a few hundredths, so that the warp is near the identity
        params["fc4"] = jax.tree.map(lambda v: 0.2 * v, params["fc4"])
    cfg = get_experiment("stn_dark_visible")  # the patch-16 variant
    cfg = cfg.replace(
        data=cfg.data.__class__(image_size=size),
        train=cfg.train.__class__(compute_dtype="float32"),
        extra={**cfg.extra, "fast_warp": fast_warp, "stn_identity_init": identity_init,
               "vit_depth": SMALL["depth"], "vit_dim": SMALL["dim"],
               "vit_heads": SMALL["heads"], "vit_mlp": SMALL["mlp_dim"]})
    stn = _STNNet(cfg)
    assert set(stn.state_dict()) == set(stn_from_flax(params))
    stn.load_state_dict(stn_from_flax(params))
    return jax_stn, params, stn


@pytest.mark.parametrize("fast_warp", [True, False])
def test_affine_stn_theta_warp_and_gradients(fast_warp):
    jax_stn, params, stn = _stn_pair(fast_warp, identity_init=False)
    r = np.random.RandomState(6)
    a, b, src = (np.tanh(r.randn(2, 64, 64, 3)).astype(np.float32) for _ in range(3))
    ct = r.randn(2, 64, 64, 3).astype(np.float32)
    ja, jb, js = jnp.asarray(a), jnp.asarray(b), jnp.asarray(src)

    want_theta = np.asarray(jax_stn.apply({"params": params}, ja, jb, method="theta"))
    assert np.abs(want_theta - np.asarray(IDENTITY_THETA).reshape(2, 3)).max() > 1e-2
    want = np.asarray(jax_stn.apply({"params": params}, ja, jb, js))
    want_g, want_gs = jax.jit(jax.grad(
        lambda p, s: jnp.sum(jax_stn.apply({"params": p}, ja, jb, s) * ct), (0, 1)))(params, js)

    ts = torch.from_numpy(src).requires_grad_()
    theta = stn.theta(torch.from_numpy(a), torch.from_numpy(b))
    assert theta.shape == (2, 2, 3) and theta.dtype == torch.float32
    np.testing.assert_allclose(theta.detach().numpy(), want_theta, atol=2e-5)
    got = stn(torch.from_numpy(a), torch.from_numpy(b), ts)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_gs),
                               atol=2e-4 * np.abs(want_gs).max())
    _assert_grads(stn, want_g, stn_from_flax)


@pytest.mark.parametrize("identity_init", [True, False])
def test_identity_init(identity_init):
    cfg = get_experiment("stn_dark_visible")
    cfg = cfg.replace(data=cfg.data.__class__(image_size=64),
                      train=cfg.train.__class__(compute_dtype="float32"),
                      extra={**cfg.extra, "stn_identity_init": identity_init, "vit_depth": 1,
                             "vit_dim": 48, "vit_heads": 2, "vit_mlp": 96})
    stn = _STNNet(cfg, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    theta = stn.theta(x, x)
    identity = torch.tensor(IDENTITY_THETA).reshape(1, 2, 3)
    if identity_init:
        assert not stn.fc4.weight.any()
        np.testing.assert_array_equal(theta.detach().numpy(), identity.expand(2, 2, 3).numpy())
        np.testing.assert_allclose(stn(x, x, x).detach().numpy(), x.numpy(), atol=1e-6)
    else:
        assert float((theta - identity).abs().max()) > 1e-3
    stn.reset_parameters(torch.Generator().manual_seed(2))
    assert bool(stn.fc4.weight.any()) != identity_init


def test_plain_affine_stn_reads_the_localization_prefix():
    """``AffineSTN`` of the JAX package keeps its ViT under localization/vit."""
    jax_stn = JaxAffineSTN()
    img = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(jax_stn.init, jax.random.PRNGKey(0), img, img, img)["params"]
    assert "localization" in shapes
    state = stn_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    stn = AffineSTN(64)
    assert isinstance(stn.vit, LocalizerViT) and stn.vit.tokens == 2
    assert set(state) == set(stn.state_dict())
    assert all(state[k].shape == v.shape for k, v in stn.state_dict().items())
    assert len(flatten_params(shapes)) == len(state)


def test_warp_src_returns_the_source_dtype():
    src = torch.rand(1, 8, 8, 3).bfloat16()
    theta = torch.tensor(IDENTITY_THETA).reshape(1, 2, 3) + 0.01
    for fast in (True, False):
        out = warp_src(src, theta, mode="bicubic", padding_mode="border", fast=fast)
        assert out.dtype == torch.bfloat16 and out.shape == src.shape
