"""GQA flash attention (causal, optionally sliding-window) in PyTorch, with
the attention itself a hand-written CUDA kernel.

``out = softmax(q·kᵀ·D^-½ + mask)·v`` for q `(B, S, H, D)` and k, v
`(B, S, KV, D)`: query head h reads KV head ``h // (H / KV)``. The mask is
causal (``q_pos >= k_pos``) and, with a window, ``q_pos - k_pos < window``.
The softmax is f32 inside; the output has q's dtype. This is what the
JAX package's Pallas `_flash_kernel` and its oracle `flash_attention_ref`
compute.

`flash_attention` runs `flash_attention_plain` on a CPU tensor and launches
`csrc/flash_attention.cu` on a CUDA tensor. Nothing falls back from one to
the other. The kernel is chosen by dtype (`PATHS`): bf16 runs on the tensor
cores (wgmma with TMA-fed K/V tiles; P·V as bf16 products over P split
into three bf16 terms, all of p's f32 bits, so the output stays within one
bf16 step of the plain version's), f32 on the CUDA cores (f32 FMAs
throughout, within 2e-5). Any other dtype raises. Unlike the Pallas
wrapper, any S is taken: the kernel masks the ragged tail of the last tile
itself. TMA wants 16-byte strides and addresses, so a bf16 call with D not
a multiple of 8 (or a misaligned tensor) hands the kernel copies padded
with zero columns (or realigned).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: which cores each dtype's kernel runs on
PATHS = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}

#: launches of the flash-attention CUDA kernel in this process:
#: `flash_attention` adds one per launch and nothing else touches it
#: (callers may reset it)
launches = 0


def _mask(S: int, causal: bool, window: int | None, device) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= i >= j
    if window is not None:
        mask &= (i - j) < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None):
    """The plain PyTorch version: a materialising f32 softmax over the
    whole `(S, S)` score matrix (the counterpart of
    `repro.kernels.ref.flash_attention_ref`). Returns `(B, S, H, D)` in
    q's dtype, on q's device."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = (q.to(torch.float32) * scale).reshape(B, S, KV, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    s = s.masked_fill(~_mask(S, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _tma_ready(x: torch.Tensor, width: int) -> torch.Tensor:
    """`x` as the bf16 kernel takes it: `width` (a multiple of 8) columns,
    the new ones zero, and a 16-byte aligned start."""
    if x.shape[-1] != width:
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """GQA attention of `(B, S, H, D)` queries over `(B, S, KV, D)` keys
    and values. CPU tensors run `flash_attention_plain`; CUDA tensors
    launch the hand-written kernel on the current stream, or raise."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"need q, k, v all float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, S, H, D) and k, v (B, S, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not 0 < D <= 256:
        raise ValueError(f"head_dim {D} not in 1..256")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.numel() == 0:
        return torch.empty_like(q)
    width = D
    if q.dtype == torch.bfloat16:
        width = -(-D // 8) * 8
        q, k, v = (_tma_ready(x, width) for x in (q, k, v))
    out = torch.empty_like(q)
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, S, H, KV, width, int(causal), 0 if window is None else min(window, S),
                     1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel did not launch: CUDA error {err}")
    launches += 1
    return out if width == D else out[..., :D].contiguous()
