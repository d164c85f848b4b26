"""The port's flash attention against the JAX package's, float32 and bfloat16
on the CPU.

On the CPU ``flash_attention`` takes its plain version (the CUDA kernels are
held against the same plain version on the card, tests/test_torch_cuda.py and
chip_smoke.py). It is compared with the JAX Pallas kernel in interpret mode
(``flash_attention(..., interpret=True)``, S a multiple of 256) and with the
straightforward XLA math of tests/test_pallas_flashattn.py, on the same numpy
inputs, forward and all three gradients; the gradients at S = 512 and 1000, so
that more than one query block and more than one key tile are crossed.

Tolerances are the JAX tests' own windows: float32 forward rtol 2e-5 / atol
2e-6, gradients rtol 3e-5 / atol 3e-6 x max(1, max|reference|) (sums of up to
1000 terms in another order), bfloat16 rtol = atol = 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfcgan_tpu.models.diffusion import AttentionBlock as JaxAttentionBlock
from tfcgan_tpu.ops.pallas_kernels.flashattn import flash_attention as jax_flash_attention
from tfcgan_tpu_torch.bridge import conv_net_from_flax
from tfcgan_tpu_torch.models.diffusion import AttentionBlock
from tfcgan_tpu_torch.ops.flashattn import flash_attention, flash_attention_plain
from tfcgan_tpu_torch.ops.kernels import flashattn as kernels

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _xla(q, k, v, scale):
    """q, k, v (BH, D, S): the XLA math of tests/test_pallas_flashattn._ref."""
    s = jnp.einsum("bdq,bdk->bqk", q, k) * scale
    p = jax.nn.softmax(s.astype(jnp.float32), axis=-1).astype(v.dtype)
    return jnp.einsum("bqk,bdk->bdq", p, v)


def _inputs(bh, d, s, seed, count=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, d, s).astype(np.float32) for _ in range(count)]


def _both(arrays, dtype):
    tt, jt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tt) for a in arrays],
            [jnp.asarray(a).astype(jt) for a in arrays])


def _close(got, want, dtype, grad=False):
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    elif grad:
        np.testing.assert_allclose(got, want, rtol=3e-5,
                                   atol=3e-6 * max(1.0, float(np.abs(want).max())))
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("seq", [256, 512])
def test_forward_matches_the_jax_kernel_in_interpret_mode(seq, d, dtype):
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, d, seq, seed=seq + d), dtype)
    scale = d ** -0.5
    out = flash_attention(q, k, v, scale)
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, jax_flash_attention(jq, jk, jv, scale, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,d", [(256, 8), (512, 8), (256, 64), (1, 8), (7, 8), (255, 8),
                                   (1000, 8), (600, 16), (130, 32)])
def test_forward_matches_the_xla_math(seq, d, dtype):
    # ragged S: the JAX kernel refuses it, the XLA math does not
    (q, k, v), (jq, jk, jv) = _both(_inputs(3, d, seq, seed=seq), dtype)
    scale = d ** -0.5
    _close(flash_attention(q, k, v, scale), _xla(jq, jk, jv, scale), dtype)


def _port_grads(q, k, v, w, scale, fn=flash_attention):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad((w * fn(q, k, v, scale)).sum(), (q, k, v))


@pytest.mark.parametrize("reference", ["kernel", "xla"])
@pytest.mark.parametrize("d", [8, 64])
def test_gradients_across_two_query_blocks(d, reference):
    # S = 512: two of the JAX kernel's query blocks, so its cross-block
    # accumulation of dk and dv runs
    (q, k, v, w), (jq, jk, jv, jw) = _both(_inputs(2, d, 512, seed=3 + d, count=4), "float32")
    scale = d ** -0.5
    if reference == "kernel":
        fn = lambda a, b, c: jax_flash_attention(a, b, c, scale, interpret=True)  # noqa: E731
    else:
        fn = lambda a, b, c: _xla(a, b, c, scale)  # noqa: E731
    want = jax.grad(lambda a, b, c: jnp.sum(jw * fn(a, b, c)), argnums=(0, 1, 2))(jq, jk, jv)
    for g, r in zip(_port_grads(q, k, v, w, scale), want):
        _close(g, r, "float32", grad=True)


@pytest.mark.parametrize("seq", [7, 255, 1000])
def test_gradients_at_ragged_lengths(seq):
    (q, k, v, w), (jq, jk, jv, jw) = _both(_inputs(2, 8, seq, seed=seq, count=4), "float32")
    scale = 8 ** -0.5
    want = jax.grad(lambda a, b, c: jnp.sum(jw * _xla(a, b, c, scale)),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for g, r in zip(_port_grads(q, k, v, w, scale), want):
        _close(g, r, "float32", grad=True)


def test_bfloat16_gradients_match_the_xla_math():
    (q, k, v, w), (jq, jk, jv, jw) = _both(_inputs(2, 8, 512, seed=11, count=4), "bfloat16")
    scale = 8 ** -0.5
    want = jax.grad(lambda a, b, c: jnp.sum((jw * _xla(a, b, c, scale)).astype(jnp.float32)),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for g, r in zip(_port_grads(q, k, v, w, scale), want):
        assert g.dtype == torch.bfloat16
        _close(g, r, "bfloat16")


def test_large_scores_do_not_overflow():
    # scores of several hundred: exp without the running maximum would be inf
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 8, 300, seed=5), "float32")
    out = flash_attention(40.0 * q, k, v, 1.0)
    assert bool(torch.isfinite(out).all())
    _close(out, _xla(40.0 * jq, jk, jv, 1.0), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_views_of_the_projections(dtype):
    """What ``AttentionBlock`` hands in: (N, heads, D, S) views of (N, S, C)
    tensors, against the packed (BH, D, S) copies of the JAX block."""
    n, s, heads, d = 2, 320, 4, 8
    rng = np.random.RandomState(2)
    tt = DTYPES[dtype][0]
    proj = [torch.from_numpy(rng.randn(n, s, heads * d).astype(np.float32)).to(tt)
            for _ in range(3)]
    views = [p.view(n, s, heads, d).permute(0, 2, 3, 1) for p in proj]
    assert not views[0].is_contiguous()
    out = flash_attention(*views, d ** -0.5)
    assert out.shape == (n, heads, d, s)
    packed = [v.reshape(n * heads, d, s) for v in views]
    want = flash_attention(*packed, d ** -0.5).view(n, heads, d, s)
    assert torch.equal(out, want)
    jp = [jnp.asarray(p.float().numpy()).astype(DTYPES[dtype][1]) for p in packed]
    _close(out.reshape(n * heads, d, s), _xla(*jp, d ** -0.5), dtype)


def test_query_chunks_and_checkpointing_change_nothing():
    (q, k, v, w), _ = _both(_inputs(2, 8, 700, seed=9, count=4), "float32")
    scale = 8 ** -0.5
    whole = flash_attention_plain(q, k, v, scale, q_chunk=4096)
    for chunk in (128, 512):
        np.testing.assert_allclose(flash_attention_plain(q, k, v, scale, q_chunk=chunk).numpy(),
                                   whole.numpy(), rtol=1e-6, atol=1e-6)
    g_whole = _port_grads(q, k, v, w, scale,
                          lambda a, b, c, s: flash_attention_plain(a, b, c, s, q_chunk=4096))
    g_chunk = _port_grads(q, k, v, w, scale,
                          lambda a, b, c, s: flash_attention_plain(a, b, c, s, q_chunk=128))
    for a, b in zip(g_chunk, g_whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_only_the_gradients_asked_for():
    (q, k, v), _ = _both(_inputs(2, 8, 64, seed=1), "float32")
    k = k.requires_grad_()
    out = flash_attention(q, k, v, 0.3)
    (gk,) = torch.autograd.grad(out.sum(), (k,))
    assert gk.shape == k.shape and not q.requires_grad and not v.requires_grad


@pytest.mark.parametrize("shapes", [((4, 8), (4, 8), (4, 8)),
                                    ((2, 8, 16), (2, 8, 17), (2, 8, 16)),
                                    ((1, 2, 8, 16), (2, 8, 16), (1, 2, 8, 16))])
def test_wrong_shapes_raise(shapes):
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(*(torch.zeros(s) for s in shapes), 1.0)


def test_kernel_wrappers_refuse_cpu_tensors():
    # the wrappers launch or raise: no fallback inside them
    x = torch.zeros(1, 2, 8, 16)
    stat = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flashattn_fwd(x, x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flashattn_bwd(x, x, x, x, stat, stat, 1.0)
    assert kernels.FWD_LAUNCHES == kernels.DQ_LAUNCHES == kernels.DKV_LAUNCHES == 0
    assert kernels.FWD_TC_LAUNCHES == kernels.DQ_TC_LAUNCHES == kernels.DKV_TC_LAUNCHES == 0
    assert kernels.HEAD_DIMS == (8, 16, 32, 64)


def _block_params(channels, seed):
    """Random flax params of an AttentionBlock (live biases and scales)."""
    rng = np.random.RandomState(seed)
    dense = lambda: {"kernel": (rng.randn(channels, channels) / np.sqrt(channels)  # noqa: E731
                                ).astype(np.float32),
                     "bias": (0.1 * rng.randn(channels)).astype(np.float32)}
    return {"group_norm": {"scale": (1 + 0.1 * rng.randn(channels)).astype(np.float32),
                           "bias": (0.1 * rng.randn(channels)).astype(np.float32)},
            "to_q": dense(), "to_k": dense(), "to_v": dense(), "to_out": dense()}


@pytest.mark.parametrize("jax_path", ["xla", "flash"])
@pytest.mark.parametrize("channels", [32, 64])
def test_attention_block_matches_the_jax_block(channels, jax_path, monkeypatch):
    """``AttentionBlock`` against the JAX block on its XLA path (the CPU
    default) and, with TFCGAN_FLASH_ATTN=1, on its Pallas kernel in interpret
    mode: 16 x 16 = 256 tokens, 4 or 8 heads. rtol 2e-5 / atol 1e-5 (the
    output is O(1) sums of 32-64 products after the attention)."""
    monkeypatch.setenv("TFCGAN_FLASH_ATTN", "1" if jax_path == "flash" else "0")
    params = _block_params(channels, seed=channels)
    x = np.random.RandomState(4).randn(2, 16, 16, channels).astype(np.float32)
    want = JaxAttentionBlock().apply({"params": params}, jnp.asarray(x))
    block = AttentionBlock(channels)
    block.load_state_dict(conv_net_from_flax(params))
    got = block(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def test_attention_block_gradients_match_the_jax_block():
    params = _block_params(64, seed=7)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, 16, 64).astype(np.float32)
    w = rng.randn(2, 16, 16, 64).astype(np.float32)
    grads = jax.grad(lambda p, xx: jnp.sum(jnp.asarray(w) * JaxAttentionBlock().apply(
        {"params": p}, xx)), argnums=(0, 1))(params, jnp.asarray(x))
    block = AttentionBlock(64)
    block.load_state_dict(conv_net_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * block(xt)).sum().backward()
    want = conv_net_from_flax(grads[0])
    for name, p in block.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads[1]), rtol=1e-4, atol=1e-5)
