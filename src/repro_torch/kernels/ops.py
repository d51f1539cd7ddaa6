"""Public kernel entry points and the fleet-scale sketch merges.

`flash_attention` is the GQA causal / sliding-window attention of
`repro_torch.kernels.flash_attention` (the hand-written CUDA kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor); the model's
attention layers call it unless given another `attn_impl`.

`ssm_scan` is Mamba's selective scan of `repro_torch.kernels.ssm_scan`
(the hand-written CUDA kernel on a CUDA tensor, its plain PyTorch version
on a CPU tensor), returning y and the final state; the model's mamba
layers call it unless given another `scan_impl`.

`quantize_int8` / `dequantize_int8` are the int8 codec of
`repro_torch.kernels.quantize` (the hand-written CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor).

`merge_moments` / `merge_histograms` / `merge_quantile_sketches` fuse
every vehicle's streaming-analytics sketch into the fleet aggregate with
a few reductions over the client axis instead of a per-client Python
loop. Plain PyTorch on `device` (the card unless the caller passes
``device="cpu"``); the inputs are host arrays or tensors and the results
come back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quantize import dequantize_int8, quantize_int8
from repro_torch.kernels.ssm_scan import ssm_scan

__all__ = [
    "dequantize_int8", "flash_attention", "merge_histograms", "merge_moments",
    "merge_quantile_sketches", "quantize_int8", "ssm_scan",
]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def merge_moments(counts, means, m2s, *, device="cuda") -> tuple[float, float, float]:
    """Merge N clients' (count, mean, M2) sketches with Chan's parallel
    combination. Returns (count, mean, M2) of the pooled samples.

    The sequential pairwise merge (`merge_moments_reference` in
    repro_torch.fleet.analytics) telescopes to the closed form
    ``C = Σcᵢ; μ = Σcᵢμᵢ/C; M2 = ΣM2ᵢ + Σcᵢ(μᵢ − μ)²``. The pooled count
    is summed exactly in int64 on the host (f32 cannot represent counts
    past 2^24); mean and M2 are f32 reductions on `device`, whose
    relative error is ~1e-7 per pooled fleet."""
    dev = resolve_device(device)
    c_exact = int(np.sum(np.asarray(counts, np.int64)))
    c = _f32(counts, dev)
    mu = _f32(means, dev)
    safe = torch.clamp(c.sum(), min=1.0)
    mean = (c * mu).sum() / safe
    m2 = _f32(m2s, dev).sum() + (c * torch.square(mu - mean)).sum()
    return float(c_exact), float(mean), float(m2)


def merge_histograms(hists, *, device="cuda") -> np.ndarray:
    """(N, bins) per-client fixed-bin counts -> (bins,) fleet counts,
    summed exactly in int64."""
    h = torch.as_tensor(np.asarray(hists, np.int64), device=resolve_device(device))
    return h.sum(dim=0).cpu().numpy()


def merge_quantile_sketches(qvals, counts, *, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Merge N clients' K-point quantile summaries (KLL-style equal-weight
    order statistics) into one fleet summary.

    Each of client i's K order statistics stands for count_i / K of its
    samples; NaN entries (count-0 clients) get zero weight, and the stable
    sort puts them last, so the zero-weight tail never sits between real
    values. Returns ``(values, cumulative_weights)`` sorted ascending; the
    weight cumsum runs in float64 on the host so fleet-scale pooled
    counts keep their rank precision."""
    dev = resolve_device(device)
    q = _f32(qvals, dev)
    K = q.shape[1]
    w = (_f32(counts, dev) / K)[:, None].expand(q.shape).reshape(-1)
    v = q.reshape(-1)
    w = torch.where(torch.isnan(v), 0.0, w)
    order = torch.argsort(v, stable=True)  # jnp.argsort is stable too
    return v[order].cpu().numpy(), np.cumsum(w[order].cpu().numpy().astype(np.float64))
