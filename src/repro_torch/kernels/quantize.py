"""Symmetric per-row int8 quantization (the upload codec), in PyTorch,
with the quantization itself a hand-written CUDA kernel.

For each row of a `(rows, cols)` f32 matrix: ``s = max(absmax, 1e-12) /
127`` and ``q = clip(round(x / s), -127, 127)`` as int8, rounding half to
even. This is what the JAX package's Pallas `_quant_kernel` and its oracle
`quantize_int8_ref` compute; `q` and `s` here are bitwise equal to both.
A NaN in a row gives that row a NaN scale, as `jnp.max` does; `q` of a
non-finite row is unspecified.

`quantize_int8` runs `quantize_int8_plain` on a CPU tensor and launches
`csrc/quantize_int8.cu` on a CUDA tensor. Nothing falls back from one to
the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches of the int8 CUDA kernel in this process: `quantize_int8` adds
#: one per launch and nothing else touches it (callers may reset it)
launches = 0


def quantize_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: `(rows, cols)` f32 -> `(rows, cols)` int8
    `q` and `(rows,)` f32 `s`, on `x`'s device."""
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)  # NaN propagates
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns a
    # division by a host scalar into a multiply by its f32 reciprocal,
    # which is not the IEEE quotient the reference computes
    scale = torch.maximum(absmax, absmax.new_tensor(1e-12)) / absmax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """`(rows, cols)` int8 and `(rows,)` scales -> `(rows, cols)` f32."""
    return q.to(torch.float32) * s[:, None]


def _launcher():
    fn = _build.load("quantize_int8").quantize_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a `(rows, cols)` f32 matrix per row. CPU tensors run
    `quantize_int8_plain`; CUDA tensors launch the hand-written kernel on
    the current stream, or raise."""
    global launches
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"need a (rows, cols) float32 matrix, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, cols = x.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, s
    launch = _launcher()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel did not launch: CUDA error {err}")
    launches += 1
    return q, s
