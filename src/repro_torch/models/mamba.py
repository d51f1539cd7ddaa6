"""Mamba (selective SSM) mixer: plain functions over a parameter dict.

Mamba-1 as Jamba uses it, as in the JAX package's `repro.models.mamba`:
in_proj -> (x, z); causal depthwise conv on x; silu; input-dependent
(dt, B, C); the selective scan h_t = exp(dt·A) h_{t-1} + dt·B x_t,
y = C·h + D·x; gated by silu(z); out_proj.

The scan core is `scan_impl`, by default `repro_torch.kernels.ops.ssm_scan`:
the hand-written CUDA kernel on the card, its plain version on the CPU. It
walks any S in one call and returns the final state, so prefill and decode
share one path; the JAX package's chunked associative scan
(`mamba_scan_chunked`) is XLA's way to compute the same function and has
no counterpart here.

Decode keeps state = {"ssm": (B, inner, d_state) f32, "conv": (B, K-1,
inner)}: O(1) per token. The products whose JAX version asks for an f32
result from bf16 operands (x_proj, dt_proj) run in f32 on operands cast up
(bf16 products are exact in f32); the others return the input's dtype.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, linear


def mamba_init(
    gen: torch.Generator,
    d_model: int,
    *,
    expand: int = 2,
    d_state: int = 16,
    d_conv: int = 4,
    dt_rank: int | None = None,
    dtype=torch.bfloat16,
) -> Params:
    """Random parameters on `gen`'s device with the reference's shapes,
    dtypes and distributions: conv_b, dt_bias, A_log and D are f32, the
    rest `dtype`; A is S4D-real (A_log = log 1..d_state) and softplus of
    dt_bias lies in [1e-3, 1e-1]."""
    inner = expand * d_model
    dt_rank = dt_rank or max(1, math.ceil(d_model / 16))
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    a = torch.arange(1, d_state + 1, **f32).repeat(inner, 1)
    conv_w = torch.randn((d_conv, inner), generator=gen, **f32) / math.sqrt(d_conv)
    u = torch.rand((inner,), generator=gen, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": dense_init(gen, d_model, 2 * inner, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((inner,), **f32),
        "x_proj": dense_init(gen, inner, dt_rank + 2 * d_state, dtype),
        "dt_proj": dense_init(gen, dt_rank, inner, dtype),
        "dt_bias": torch.log(torch.exp(dt) - 1.0),  # softplus^-1 of dt
        "A_log": torch.log(a),
        "D": torch.ones((inner,), **f32),
        "out_proj": dense_init(gen, inner, d_model, dtype),
    }


def _split_xz(params: Params, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xz = linear(u, params["in_proj"])
    inner = xz.shape[-1] // 2
    return xz[..., :inner], xz[..., inner:]


def _conv_causal(params: Params, x: torch.Tensor, init: torch.Tensor | None = None):
    """Depthwise causal conv along S of x (B, S, inner), accumulated in
    f32. Returns (y in x's dtype, tail = the last K-1 inputs: the decode
    conv state)."""
    K = params["conv_w"].shape[0]
    B, S, inner = x.shape
    if init is None:
        init = torch.zeros((B, K - 1, inner), dtype=x.dtype, device=x.device)
    xp = torch.cat([init.to(x.dtype), x], dim=1)  # (B, S+K-1, inner)
    w = params["conv_w"].to(torch.float32)
    y = torch.zeros((B, S, inner), dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + S].to(torch.float32) * w[i]
    y = y + params["conv_b"]
    return y.to(x.dtype), xp[:, xp.shape[1] - (K - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as `jax.nn.softplus` computes it (logaddexp(x, 0))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _dt_b_c(params: Params, x: torch.Tensor, d_state: int):
    """x (B, S, inner) -> dt (B, S, inner) f32, Bm and Cm (B, S, state)
    f32, each contiguous."""
    proj = torch.matmul(x.to(torch.float32), params["x_proj"].to(torch.float32))
    dt_rank = proj.shape[-1] - 2 * d_state
    dt_low = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + d_state].contiguous()
    Cm = proj[..., dt_rank + d_state:].contiguous()
    dt = torch.matmul(dt_low.to(x.dtype).to(torch.float32),
                      params["dt_proj"].to(torch.float32))
    return _softplus(dt + params["dt_bias"]), Bm, Cm


def mamba_apply(
    params: Params,
    u: torch.Tensor,  # (B, S, d)
    *,
    d_state: int,
    state: dict[str, torch.Tensor] | None = None,
    return_state: bool = False,
    scan_impl: Callable | None = None,
) -> Any:
    """The mamba mixer over u. With `state`, continues from it (its conv
    tail and ssm state); with `return_state`, also returns {"ssm", "conv"}
    for decode. `scan_impl(dt, Bm, Cm, x, A, h0) -> (y, h)` is the scan
    core; None means `ops.ssm_scan`."""
    scan = ops.ssm_scan if scan_impl is None else scan_impl
    x, z = _split_xz(params, u)
    x_conv, conv_tail = _conv_causal(params, x, None if state is None else state["conv"])
    x_act = F.silu(x_conv.to(torch.float32)).to(u.dtype)
    dt, Bm, Cm = _dt_b_c(params, x_act, d_state)
    A = -torch.exp(params["A_log"])
    y, h = scan(dt, Bm, Cm, x_act, A, None if state is None else state["ssm"])
    y = y + x_act.to(torch.float32) * params["D"]
    y = y * F.silu(z.to(torch.float32))
    out = linear(y.to(u.dtype), params["out_proj"])
    if not return_state:
        return out
    return out, {"ssm": h, "conv": conv_tail.contiguous()}


def mamba_decode(
    params: Params,
    u: torch.Tensor,  # (B, 1, d)
    state: dict[str, torch.Tensor],
    *,
    d_state: int,
    scan_impl: Callable | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token: `mamba_apply` on u from `state`; returns (out, new state)."""
    return mamba_apply(params, u, d_state=d_state, state=state, return_state=True,
                       scan_impl=scan_impl)


__all__ = ["mamba_apply", "mamba_decode", "mamba_init"]
