"""Federated learning over the AutoSPADA platform: configuration.

A *round* is an assignment whose tasks carry the current global model as
Parameters; each vehicle trains locally and publishes a compressed model
delta; the server aggregates whatever arrived by the deadline.

The round's math (local SGD, FedAvg aggregation, the int8 upload codec,
pairwise masks) is the next slice of the port: `FEDERATED_PENDING` is what
every entry that needs it raises. `FedConfig` is ported, because the
simulator and the gateway carry it.
"""
from __future__ import annotations

import dataclasses

#: the error every not-yet-ported federated entry raises
FEDERATED_PENDING = "federated rounds: next slice of the port"


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


def local_sgd(*args, **kwargs):
    raise NotImplementedError(FEDERATED_PENDING)


def client_delta(*args, **kwargs):
    raise NotImplementedError(FEDERATED_PENDING)


def aggregate_deltas(*args, **kwargs):
    raise NotImplementedError(FEDERATED_PENDING)


def pairwise_masks(*args, **kwargs):
    raise NotImplementedError(FEDERATED_PENDING)
