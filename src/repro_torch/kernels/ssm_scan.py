"""Mamba's selective scan in PyTorch, with the scan itself a hand-written
CUDA kernel.

For dt, x `(B, S, inner)`, Bm, Cm `(B, S, state)` and A `(inner, state)`:

    h_t = exp(dt_t · A) · h_{t-1} + (dt_t · x_t) · B_t     (B, inner, state)
    y_t = Σ_state h_t · C_t                                (B, inner)

from ``h_0 = h0`` (zeros when absent). Everything is f32 inside; dt, Bm, Cm
and A are f32, x is f32 or bf16, and y and the final h come back in f32.
This is what the JAX package's Pallas `_ssm_kernel` and its oracle
`ssm_scan_ref` compute; unlike the Pallas wrapper, the final state comes
back too (the mixer's decode cache needs it) and any S and inner are taken.

`ssm_scan` runs `ssm_scan_plain` on a CPU tensor and launches
`csrc/ssm_scan.cu` on a CUDA tensor. Nothing falls back from one to the
other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the d_state the kernel is built for (csrc/ssm_scan.cu, kState): every
#: config in the repo uses 16
KERNEL_STATE = 16

#: launches of the selective-scan CUDA kernel in this process: `ssm_scan`
#: adds one per launch and nothing else touches it (callers may reset it)
launches = 0


def ssm_scan_plain(dt, Bm, Cm, x, A, h0=None):
    """The plain PyTorch version: the recurrence one time step at a time
    (the counterpart of `repro.kernels.ref.ssm_scan_ref`), in f32 on dt's
    device. Returns (y (B, S, inner), h (B, inner, state))."""
    B, S, inner = dt.shape
    h = (torch.zeros((B, inner, A.shape[1]), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.to(torch.float32))
    A = A.to(torch.float32)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(torch.float32)
        abar = torch.exp(dt_t[..., None] * A[None])
        bx = (dt_t * x[:, t].to(torch.float32))[..., None] * Bm[:, t].to(torch.float32)[:, None, :]
        h = abar * h + bx
        ys.append((h * Cm[:, t].to(torch.float32)[:, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(dt, dtype=torch.float32)
    return y, h


def ssm_scan_tolerance(dt, Bm, Cm, x, A, h0=None):
    """Elementwise bounds (tol_y (B, S, inner), tol_h (B, inner, state)) on
    how far two f32 evaluations of the scan may part by rounding alone.

    Each step of either one rounds `dt·A`, the exponential (an `expf`
    within 2 ulp), `dt·x`, two products and a sum: the two may part by
    at most 16u (u = 2^-24) of m_t = abar·m_{t-1} + |dt·x·B|, which
    bounds |h_t| from m_0 = |h0|. The parting carries forward damped by
    abar, so |Δh_t| <= 16u·e_t with e_t = abar·e_{t-1} + m_t; y's 16-term
    sum over the state adds at most 16u·Σ|h·C|. So tol_h = 16u·e_S and
    tol_y_t = 16u·Σ_state |C_t|·(e_t + m_t). Computed in f32 one time
    step at a time, like `ssm_scan_plain`."""
    u16 = 16 * 2.0**-24
    B, S, inner = dt.shape
    A = A.to(torch.float32)
    m = (torch.zeros((B, inner, A.shape[1]), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.to(torch.float32).abs())
    e = torch.zeros_like(m)
    tol_y = torch.empty((B, S, inner), dtype=torch.float32, device=dt.device)
    for t in range(S):
        dt_t = dt[:, t].to(torch.float32)
        abar = torch.exp(dt_t[..., None] * A[None])
        bx = (dt_t * x[:, t].to(torch.float32)).abs()[..., None] * Bm[:, t].abs()[:, None, :]
        m = abar * m + bx
        e = abar * e + m
        tol_y[:, t] = u16 * ((e + m) * Cm[:, t].abs()[:, None, :]).sum(-1)
    return tol_y, u16 * e


def _launcher():
    fn = _build.load("ssm_scan").ssm_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(dt, Bm, Cm, x, A, h0) -> None:
    tensors = {"dt": dt, "Bm": Bm, "Cm": Cm, "x": x, "A": A}
    if h0 is not None:
        tensors["h0"] = h0
    if any(t.device != dt.device for t in tensors.values()):
        raise ValueError("dt, Bm, Cm, x, A and h0 must be on one device")
    for name, t in tensors.items():
        if name != "x" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if dt.dim() != 3 or Bm.dim() != 3 or A.dim() != 2:
        raise ValueError(f"need dt, x (B, S, inner), Bm, Cm (B, S, state) and A (inner, state), "
                         f"got {tuple(dt.shape)}, {tuple(Bm.shape)}, {tuple(A.shape)}")
    B, S, inner = dt.shape
    state = A.shape[1]
    want = {"x": (B, S, inner), "Bm": (B, S, state), "Cm": (B, S, state),
            "A": (inner, state), "h0": (B, inner, state)}
    for name, shape in want.items():
        if name in tensors and tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} {tuple(tensors[name].shape)} does not match {shape}")
    if state != KERNEL_STATE:
        raise ValueError(f"the kernel is built for d_state {KERNEL_STATE}, got {state}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("dt, Bm, Cm, x, A and h0 must be contiguous")


def ssm_scan(dt, Bm, Cm, x, A, h0=None):
    """The selective scan of dt, x `(B, S, inner)` with Bm, Cm
    `(B, S, state)` and A `(inner, state)` from h0 `(B, inner, state)`
    (zeros if None). Returns (y (B, S, inner) f32, final h (B, inner,
    state) f32). CPU tensors run `ssm_scan_plain`; CUDA tensors launch the
    hand-written kernel on the current stream, or raise."""
    global launches
    if dt.device.type == "cpu":
        return ssm_scan_plain(dt, Bm, Cm, x, A, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {dt.device}")
    _check(dt, Bm, Cm, x, A, h0)
    B, S, inner = dt.shape
    state = A.shape[1]
    y = torch.empty((B, S, inner), dtype=torch.float32, device=dt.device)
    h = torch.empty((B, inner, state), dtype=torch.float32, device=dt.device)
    if B * inner == 0:
        return y, h
    launch = _launcher()
    with torch.cuda.device(dt.device):
        err = launch(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(), A.data_ptr(),
                     0 if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
                     B, S, inner, state, int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel did not launch: CUDA error {err}")
    launches += 1
    return y, h
