"""Carry the JAX package's parameters and decode caches over to the port.

The JAX model stacks each group's layers on a leading `repeats` axis and
applies a group as ``for r in range(repeats): for i in range(len(pattern))``,
so the port's flat layer index is ``group_offset + r * len(pattern) + i``
(gemma3's ``(5L + 1G) × 4 + 2L`` is the schedule that a wrong order breaks).
Weights keep the JAX layout `(d_in, d_out)`: nothing is transposed.

The inputs are numpy arrays (``jax.tree.map(np.asarray, params)``); bf16
arrays (ml_dtypes) come over bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import ArchConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _layer(tree: dict, r: int, device) -> dict:
    """Entry r of every stacked leaf of one pattern position's tree."""
    return {k: _layer(v, r, device) if isinstance(v, dict) else _tensor(np.asarray(v)[r], device)
            for k, v in tree.items()}


def _flat_layers(cfg: ArchConfig, groups: list, device) -> list:
    return [_layer(group[str(i)], r, device)
            for (pattern, repeats), group in zip(cfg.groups, groups)
            for r in range(repeats) for i in range(len(pattern))]


def params_from_jax(cfg: ArchConfig, tree: dict[str, Any], *, device="cuda") -> dict[str, Any]:
    """The port's parameters (`repro_torch.models.model`'s layout) from the
    JAX package's parameter tree, on `device`."""
    dev = resolve_device(device)
    params = {"layers": _flat_layers(cfg, tree["groups"], dev),
              "final_norm": _tensor(tree["final_norm"], dev)}
    for name in ("embed", "lm_head"):
        if name in tree:
            params[name] = _tensor(tree[name], dev)
    return params


def cache_from_jax(cfg: ArchConfig, cache: dict[str, Any], *, device="cuda") -> dict[str, Any]:
    """The port's decode cache from the JAX package's, on `device`."""
    dev = resolve_device(device)
    return {"layers": _flat_layers(cfg, cache["groups"], dev),
            "position": int(np.asarray(cache["position"]))}
