"""Shared neural-net building blocks (plain functions over parameter dicts).

Conventions, as in the JAX package's `repro.models.layers`:
* parameters are nested dicts of tensors; weights are stored in the
  config's `param_dtype` (bf16 for the full-size configs) with the JAX
  layout `(d_in, d_out)`, so `linear` is ``x @ w`` and nothing is
  transposed on the way in or out;
* no biases on projection layers;
* every function is shape-polymorphic over batch and sequence, so the same
  code serves prefill (B, S) and decode (B, 1).

Initialisation draws from an explicit `torch.Generator` (on the device the
parameters live on) with the reference's distributions; it does not give
the reference's numbers (jax.random is another generator).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# --------------------------------------------------------------------- #
# init helpers                                                          #
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    """`normal · 1/√d_in`, drawn in f32 and cast to `dtype`."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    """`normal · 0.02`, drawn in f32 and cast to `dtype`."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm_init(d: int, device) -> torch.Tensor:
    # zero-centred scale (gemma convention: weight = 1 + scale)
    return torch.zeros((d,), dtype=torch.float32, device=device)


# --------------------------------------------------------------------- #
# norms                                                                 #
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · (1 + scale)`` in f32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


# --------------------------------------------------------------------- #
# rotary position embeddings                                            #
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Split-half
    rotation (the first half of D pairs with the second), in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# projections                                                           #
# --------------------------------------------------------------------- #
def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype: a plain large product, left to
    `torch.matmul` (on the card cuBLAS accumulates bf16 products in f32,
    as the reference's `preferred_element_type=f32` asks)."""
    return torch.matmul(x, w).to(x.dtype)


# --------------------------------------------------------------------- #
# SwiGLU MLP                                                            #
# --------------------------------------------------------------------- #
def swiglu_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype),
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, params["w_gate"])
    u = linear(x, params["w_up"])
    return linear(F.silu(g) * u, params["w_down"])


# --------------------------------------------------------------------- #
# embedding / logits                                                    #
# --------------------------------------------------------------------- #
def embed(tok_table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return tok_table[tokens]


def logits_for_last(
    hidden_last: torch.Tensor,  # (B, 1, d)
    w_unembed: torch.Tensor,  # (d, V), V possibly padded
    valid_vocab: int | None = None,
) -> torch.Tensor:
    """f32 logits of the last position; padded vocab columns are -1e30.
    The product runs in f32 (the reference's bf16 products summed in f32
    with an f32 result). The reference's `logit_softcap` has no caller and
    is not ported."""
    logits = torch.matmul(hidden_last.to(torch.float32), w_unembed.to(torch.float32))
    V = w_unembed.shape[1]
    if valid_vocab is not None and valid_vocab < V:
        valid = torch.arange(V, device=logits.device) < valid_vocab
        logits = logits.masked_fill(~valid[None, None, :], -1e30)
    return logits


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
