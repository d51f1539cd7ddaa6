"""Federated learning over the AutoSPADA platform.

The paper's §8 active-learning use case generalized: a *round* is an
assignment whose tasks carry the current global model as Parameters
(exactly the paper's "distribute a model to many clients" example);
each vehicle client trains locally in its task container and publishes a
(compressed) model delta as a result; the server aggregates whatever
arrived by the deadline (stragglers simply miss the round — state-based
sync means their results surface later and are ignored by round id).

This file holds the math (local SGD with `torch.func.grad`, FedAvg
aggregation) over parameter trees of tensors; the orchestration lives in
`repro_torch.fleet.rounds` (platform-driven). Compressed deltas go through
the codecs of `repro_torch.fleet.compression`, so the int8 codec runs the
hand-written CUDA kernel wherever the parameters live on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.fleet.compression import (
    ErrorFeedback,
    flatten_pytree,
    make_codec,
    tree_map,
    unflatten_pytree,
)

Params = Any

#: what `pairwise_masks` raises: its masks are `jax.random.normal` draws,
#: which need the threefry port that comes with the drive-cycle scenarios
FEDERATED_PENDING = (
    "pairwise_masks draws jax.random.normal's threefry bits, which are not "
    "ported yet: ROADMAP queue 1, 'drive-cycle scenarios, with threefry parity'"
)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    rounds: int = 5
    local_steps: int = 4
    local_lr: float = 0.1
    server_lr: float = 1.0
    codec: str = "int8"  # none | int8 | topk
    codec_kwargs: tuple = ()
    deadline_fraction: float = 1.0  # fraction of clients awaited per round
    #: hard per-round pump budget (simulation ticks); None = wait for the
    #: quorum forever. With a budget the round closes on time with whatever
    #: deltas arrived — the paper's wall-clock deadline semantics.
    deadline_pumps: int | None = None


def local_sgd(
    loss_fn: Callable[[Params, Any], torch.Tensor],
    params: Params,
    batch: Any,
    *,
    steps: int,
    lr: float,
) -> Params:
    """Plain local SGD (FedAvg's client optimizer)."""
    grad = torch.func.grad(loss_fn)
    for _ in range(steps):
        g = grad(params, batch)
        params = tree_map(lambda w, gw: w - lr * gw, params, g)
    return params


def client_delta(
    loss_fn, params: Params, batch: Any, cfg: FedConfig, ef: ErrorFeedback | None
) -> dict[str, Any]:
    """Run local training, return the (optionally compressed) delta msg."""
    new_params = local_sgd(
        loss_fn, params, batch, steps=cfg.local_steps, lr=cfg.local_lr
    )
    delta = tree_map(lambda a, b: a - b, new_params, params)
    flat, treedef, shapes = flatten_pytree(delta)
    if ef is None:
        codec = make_codec(cfg.codec, **dict(cfg.codec_kwargs))
        msg = codec.encode(flat)
    else:
        msg = ef.compress(flat)
    return {"msg": msg, "treedef": treedef, "shapes": shapes}


def aggregate_deltas(
    params: Params,
    deltas: list[dict[str, Any]],
    cfg: FedConfig,
    weights: list[float] | None = None,
) -> Params:
    """FedAvg: weighted mean of decoded deltas applied at server_lr."""
    if not deltas:
        return params
    codec = make_codec(cfg.codec, **dict(cfg.codec_kwargs))
    weights = weights or [1.0] * len(deltas)
    total = sum(weights)
    flat_sum = None
    td, shp = deltas[0]["treedef"], deltas[0]["shapes"]
    for d, w in zip(deltas, weights):
        flat = codec.decode(d["msg"]) * (w / total)
        flat_sum = flat if flat_sum is None else flat_sum + flat
    mean_delta = unflatten_pytree(flat_sum, td, shp)
    return tree_map(
        lambda p, g: (p + cfg.server_lr * g).to(p.dtype), params, mean_delta
    )


def pairwise_masks(n_clients: int, dim: int, seed: int):
    """Zero-sum secure-aggregation masks (paper §3.5). The JAX package
    draws them from `jax.random.normal`; raises `NotImplementedError`
    until the port has its threefry twin."""
    raise NotImplementedError(FEDERATED_PENDING)
