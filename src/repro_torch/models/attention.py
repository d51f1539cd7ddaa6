"""Attention layers: projections, qk-norm, rotary embeddings, the attention
core, and the decode path against a KV cache.

* ``attention_apply`` / ``attention_prefill`` run the core through
  `attn_impl`, by default `repro_torch.kernels.ops.flash_attention`: the
  hand-written CUDA kernel on the card, its plain version on the CPU. The
  kernel takes the window itself (``window >= S`` masks nothing), so one
  call covers what the JAX package splits between its XLA twins
  `flash_attention` (global layers) and `local_attention` (windowed).
* ``decode_attention`` is one-token attention against a (possibly rolling)
  cache, in plain torch: the JAX package has no kernel for it either.

GQA throughout: H query heads grouped over KV heads (H = KV * G). The
softmax is f32. Layouts are the JAX package's: activations (B, S, H, D),
caches (B, Smax, KV, D).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, dense_init, linear, rms_norm

NEG_INF = -1e30


# --------------------------------------------------------------------- #
# parameter init                                                        #
# --------------------------------------------------------------------- #
def attention_init(
    gen: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    dtype,
    qk_norm: bool = False,
) -> Params:
    p: Params = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros((head_dim,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.zeros((head_dim,), dtype=torch.float32, device=gen.device)
    return p


# --------------------------------------------------------------------- #
# cores                                                                 #
# --------------------------------------------------------------------- #
def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, Smax, KV, D)
    v_cache: torch.Tensor,
    *,
    valid_len: int,  # number of valid cache entries (rolling => Smax)
    scale: float | None = None,
) -> torch.Tensor:
    """One-token attention against a cache; masks slots >= valid_len.
    Products of the cache's dtype summed in f32, the probabilities cast
    to the cache's dtype before the second product, as the reference."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = (q * scale).reshape(B, 1, KV, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32), k_cache.to(torch.float32))
    Smax = k_cache.shape[1]
    valid = torch.arange(Smax, device=q.device) < valid_len
    s = s.masked_fill(~valid[None, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(torch.float32), v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D): materialised GQA repeat."""
    G = n_heads // k.shape[2]
    return torch.repeat_interleave(k, G, dim=2)


def reference_attention(q, k, v, *, causal=True, window=None, scale=None) -> torch.Tensor:
    """O(S^2)-memory oracle (materialises the score matrix); the
    probabilities are cast to v's dtype before the second product, as in
    the JAX package's `reference_attention`."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = (q * scale).reshape(B, S, KV, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32), k.to(torch.float32))
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i >= j
    if window is not None:
        mask &= (i - j) < window
    s = s.masked_fill(~mask[None, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(torch.float32), v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


# --------------------------------------------------------------------- #
# full attention layer (projections + rope + core)                      #
# --------------------------------------------------------------------- #
def _project(params: Params, x, *, n_heads, n_kv_heads, head_dim, positions, rope_theta):
    """q (B, S, H, D), k and v (B, S, KV, D), after qk-norm and rope."""
    B, S, _ = x.shape
    q = linear(x, params["wq"]).reshape(B, S, n_heads, head_dim)
    k = linear(x, params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = linear(x, params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions.dim() == 1:
        positions = positions[None, :]
    if rope_theta:  # theta == 0 => no positional encoding (e.g. jamba)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _attend(params, q, k, v, *, n_heads, window, attn_impl):
    B, S, _, head_dim = q.shape
    impl = ops.flash_attention if attn_impl is None else attn_impl
    out = impl(q, k, v, window=window)
    return linear(out.reshape(B, S, n_heads * head_dim), params["wo"])


def attention_apply(
    params: Params,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,  # (B, S) or (S,)
    rope_theta: float,
    window: int | None = None,
    attn_impl: Callable | None = None,
) -> torch.Tensor:
    """Causal (and, with `window`, sliding-window) self-attention of x.
    `attn_impl(q, k, v, window=)` is the core; None means
    `ops.flash_attention`. The JAX twin's `q_block` / `kv_block` have no
    counterpart: the kernel picks its own tiles."""
    q, k, v = _project(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                       head_dim=head_dim, positions=positions, rope_theta=rope_theta)
    return _attend(params, q, k, v, n_heads=n_heads, window=window,
                   attn_impl=attn_impl)


def attention_prefill(
    params: Params,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,
    rope_theta: float,
    window: int | None,
    cache_len: int,
    attn_impl: Callable | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Prefill: as `attention_apply`, and also the layer's KV cache, laid
    out for decode in KV-head layout: the last `eff` keys of the prompt
    (eff = min(window, cache_len), or cache_len for a global layer), or
    the prompt's keys followed by zeros when it is shorter. k and v are
    computed once and serve both (the reference computes them twice, with
    the same result)."""
    B, S, _ = x.shape
    q, k, v = _project(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                       head_dim=head_dim, positions=positions, rope_theta=rope_theta)
    out = _attend(params, q, k, v, n_heads=n_heads, window=window,
                  attn_impl=attn_impl)
    eff = min(window, cache_len) if window is not None else cache_len
    if S >= eff:
        k_c, v_c = k[:, S - eff:].contiguous(), v[:, S - eff:].contiguous()
    else:
        pad = (0, 0, 0, 0, 0, eff - S)
        k_c, v_c = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return out, {"k": k_c, "v": v_c}


def attention_decode(
    params: Params,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict[str, torch.Tensor],
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    position: int,  # absolute position of the new token, one for the batch
    rope_theta: float,
    window: int | None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: write the new key and value into the cache, attend,
    project. The cache is updated in place and returned.

    The slot is the reference's: ``position % Smax`` for a windowed layer,
    ``position`` for a global one, clamped to ``Smax - 1`` as
    `jax.lax.dynamic_update_slice_in_dim` clamps it (a global layer past
    its cache keeps overwriting the last slot). After a windowed prefill
    longer than the window whose length is not a multiple of it, that slot
    is not the oldest entry: the reference's fault, reproduced."""
    B = x.shape[0]
    pos_b = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = _project(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                       head_dim=head_dim, positions=pos_b, rope_theta=rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    Smax = k_cache.shape[1]
    slot = position % Smax if window is not None else position
    slot = min(max(slot, 0), Smax - 1)
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, valid_len=min(position + 1, Smax))
    y = linear(out.reshape(B, 1, n_heads * head_dim), params["wo"])
    return y, {"k": k_cache, "v": v_cache}


__all__ = [
    "attention_apply", "attention_decode", "attention_init", "attention_prefill",
    "decode_attention", "reference_attention", "repeat_kv",
]
