"""Flash self-attention for the diffusion U-Net's spatial attention, port of
``tfcgan_tpu.ops.pallas_kernels.flashattn``.

``flash_attention(q, k, v, scale)`` keeps the JAX entry point's signature and
axis order: q, k, v are ``(BH, D, S)``, head_dim before sequence, and so is the
result; it also takes ``(N, heads, D, S)``. The keys may be longer than the
queries (k and v ``(..., D, Sk)``, q ``(..., D, Sq)``): on the spatial mesh axis
a rank's queries of its rows attend to the whole map's keys. Per (batch, head),

    o = softmax(q^T k * scale, over keys) v

with float32 scores and softmax statistics, the probabilities cast to v's
dtype before they multiply v. A CUDA tensor goes through ``FlashAttention``,
the autograd function around the hand-written kernels
(``ops/kernels/flashattn.py``): the scores never reach device memory, the
backward recomputes them from the saved log-sum-exp and computes only the
gradients autograd asks for. In bfloat16 the forward and both backward kernels
run their products on the tensor cores; in float32 on the float32 units. The kernels read through the strides they are
given, so ``models/diffusion.AttentionBlock`` hands in permuted views of its
``(N, S, C)`` projections and gets the result in the same memory order. Any S
>= 1; D in the kernels' ``HEAD_DIMS`` (8, 16, 32, 64). A CPU tensor goes to ``flash_attention_plain``, and
nothing else does.

``flash_attention_plain`` is the plain version on any device: the ``qblock``
math of the JAX ``AttentionBlock`` (scores * scale -> float32 softmax -> cast
to v's dtype -> P V), over chunks of queries so that the float32 scores of a
chunk, not of the whole sequence, are live; under autograd each chunk is
checkpointed, so the backward recomputes a chunk's probabilities instead of
keeping all of them. (The kernels' bfloat16 rounding differs in one place:
the forward rounds the unnormalised probability, the plain version the
normalised one.)
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from tfcgan_tpu_torch.ops.kernels import flashattn as _kernel

PLAIN_Q_CHUNK = 512  # query rows whose scores against every key are live at once


def _qblock(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(..., D, Q) queries against all keys: (..., D, Q)."""
    a = torch.matmul(qc.float().transpose(-1, -2), k.float()) * scale  # (..., Q, S)
    p = torch.softmax(a, dim=-1).to(v.dtype)
    return torch.matmul(v, p.transpose(-1, -2))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          q_chunk: int = PLAIN_Q_CHUNK) -> torch.Tensor:
    """The plain version: q (..., D, Sq), k and v (..., D, Sk) -> (..., D, Sq)
    in q's dtype. Differentiable in all three."""
    s = q.shape[-1]
    track = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for start in range(0, s, q_chunk):
        qc = q[..., start:start + q_chunk]
        if track and s > q_chunk:
            outs.append(checkpoint(_qblock, qc, k, v, scale, use_reentrant=False))
        else:
            outs.append(_qblock(qc, k, v, scale))
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op on (N, H, D, S) CUDA views."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = _kernel.flashattn_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        if not (need_q or need_k or need_v):
            return None, None, None, None
        # di[i] = sum_d o * do: a small elementwise reduction, shared by both kernels
        di = (o.float() * do.float()).sum(dim=2).contiguous()
        dq, dk, dv = _kernel.flashattn_bwd(q, k, v, do, lse, di, ctx.scale, need_q, need_k,
                                           need_v)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
                    ) -> torch.Tensor:
    """q: (BH, D, Sq) or (N, heads, D, Sq), k and v the same with Sk keys,
    float32 or bfloat16 -> q's shape in q's dtype. The kernels on CUDA, the
    plain version on the CPU."""
    if q.dim() not in (3, 4) or k.shape != v.shape or k.shape[:-1] != q.shape[:-1]:
        raise ValueError("flash_attention takes k and v of one shape, and q of that shape "
                         "but for the sequence length: (BH, D, S) or (N, heads, D, S); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.dim() == 3:
        return FlashAttention.apply(q[None], k[None], v[None], float(scale))[0]
    return FlashAttention.apply(q, k, v, float(scale))
