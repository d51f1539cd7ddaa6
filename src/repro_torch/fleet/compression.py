"""Result/gradient compression for the slow edge (paper §3.4 network
budget, adapted to distributed learning).

* int8 symmetric quantization with per-row scales (the hand-written CUDA
  kernel `kernels/csrc/quantize_int8.cu` on the card, its plain PyTorch
  version on the CPU) — 4x over f32;
* top-k sparsification — transmit the k largest-magnitude entries;
* error feedback (Seide et al. / Karimireddy et al.): the compression
  residual is accumulated locally and added before the next compression,
  which keeps SGD convergent under aggressive compression.

Everything operates on flat f32 tensors; `flatten_pytree` /
`unflatten_pytree` adapt parameter trees (dicts, lists, tuples and
namedtuples of tensors) and order their leaves as `jax.tree.flatten`
does: a plain dict by sorted key, an `OrderedDict` (a `state_dict()`) in
insertion order. So a flat vector means the same thing in both packages,
and a tree comes back with its own container types.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import dequantize_int8, quantize_int8


# --------------------------------------------------------------------- #
# pytree <-> flat vector                                                 #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a parameter tree: `kind` is "dict", "list",
    "tuple", "none" or "leaf"; `keys` are a dict's keys in leaf order;
    `cls` is a dict's type (`dict` or `OrderedDict`) or a namedtuple's."""

    kind: str
    keys: tuple = ()
    children: tuple = ()
    cls: type | None = None


def _flatten(tree: Any, leaves: list) -> TreeDef:
    if isinstance(tree, dict):
        # jax keeps an OrderedDict's insertion order and sorts any other dict
        ordered = isinstance(tree, OrderedDict)
        keys = tuple(tree) if ordered else tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(_flatten(tree[k], leaves) for k in keys),
                       OrderedDict if ordered else dict)
    if isinstance(tree, list):
        return TreeDef("list", (), tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, tuple):
        named = type(tree) if hasattr(type(tree), "_fields") else None
        return TreeDef("tuple", (), tuple(_flatten(t, leaves) for t in tree), named)
    if tree is None:
        return TreeDef("none")
    leaves.append(tree)
    return TreeDef("leaf")


def _unflatten(td: TreeDef, leaves) -> Any:
    if td.kind == "leaf":
        return next(leaves)
    if td.kind == "none":
        return None
    children = [_unflatten(c, leaves) for c in td.children]
    if td.kind == "dict":
        return td.cls(zip(td.keys, children))
    if td.kind == "list":
        return children
    return td.cls(*children) if td.cls else tuple(children)


def tree_leaves(tree: Any) -> list:
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` (and of the trees in `rest`, which
    share its structure), rebuilt in `tree`'s structure."""
    leaves: list = []
    td = _flatten(tree, leaves)
    others = [tree_leaves(r) for r in rest]
    return _unflatten(td, iter([fn(*xs) for xs in zip(leaves, *others)]))


def flatten_pytree(tree: Any) -> tuple[torch.Tensor, TreeDef, list]:
    leaves: list = []
    treedef = _flatten(tree, leaves)
    shapes = [(tuple(leaf.shape), leaf.dtype) for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    return flat, treedef, shapes


def unflatten_pytree(flat: torch.Tensor, treedef: TreeDef, shapes: list) -> Any:
    leaves = []
    off = 0
    for shape, dtype in shapes:
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off : off + n].reshape(shape).to(dtype))
        off += n
    return _unflatten(treedef, iter(leaves))


# --------------------------------------------------------------------- #
# codecs                                                                 #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Int8Codec:
    """Per-chunk-of-`row` int8 quantization."""

    row: int = 4096

    def encode(self, flat: torch.Tensor) -> dict[str, Any]:
        n = flat.shape[0]
        pad = (-n) % self.row
        x = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, self.row)
        q, s = quantize_int8(x)
        return {"kind": "int8", "q": q, "s": s, "n": n}

    def decode(self, msg: dict[str, Any]) -> torch.Tensor:
        return dequantize_int8(msg["q"], msg["s"]).reshape(-1)[: msg["n"]]

    def nbytes(self, msg: dict[str, Any]) -> int:
        return int(msg["q"].numel() + msg["s"].numel() * 4)


@dataclasses.dataclass(frozen=True)
class TopKCodec:
    """Keep the k largest-magnitude entries (indices + values)."""

    fraction: float = 0.01

    def encode(self, flat: torch.Tensor) -> dict[str, Any]:
        n = flat.shape[0]
        k = max(1, int(n * self.fraction))
        # jax.lax.top_k puts the largest first and, among equal
        # magnitudes, the lowest index first. torch.topk breaks ties its
        # own way, so it only finds the k-th magnitude: every entry above
        # it is kept, then the lowest-indexed entries equal to it, and only
        # the k kept ones are sorted (stably, so ties stay in index order)
        mag = torch.abs(flat)
        kth = torch.topk(mag, k, sorted=False).values.min()
        above = torch.nonzero(mag > kth).squeeze(1)
        tied = torch.nonzero(mag == kth).squeeze(1)[: k - above.shape[0]]
        order = torch.sort(mag[above], descending=True, stable=True).indices
        idx = torch.cat([above[order], tied])
        return {"kind": "topk", "idx": idx.to(torch.int32), "val": flat[idx], "n": n}

    def decode(self, msg: dict[str, Any]) -> torch.Tensor:
        out = torch.zeros((msg["n"],), dtype=torch.float32, device=msg["val"].device)
        out[msg["idx"].long()] = msg["val"]
        return out

    def nbytes(self, msg: dict[str, Any]) -> int:
        return int(msg["idx"].numel() * 4 + msg["val"].numel() * 4)


@dataclasses.dataclass(frozen=True)
class NullCodec:
    def encode(self, flat: torch.Tensor) -> dict[str, Any]:
        return {"kind": "raw", "val": flat}

    def decode(self, msg: dict[str, Any]) -> torch.Tensor:
        return msg["val"]

    def nbytes(self, msg: dict[str, Any]) -> int:
        return int(msg["val"].numel() * 4)


def make_codec(name: str, **kw) -> Any:
    return {"int8": Int8Codec, "topk": TopKCodec, "none": NullCodec}[name](**kw)


# --------------------------------------------------------------------- #
# batched aggregation (the fleet-scale hot path)                         #
# --------------------------------------------------------------------- #
def batched_dequant_mean(q, s, weights=None, *, device="cuda") -> np.ndarray:
    """Weighted mean of N packed int8 deltas, computed in one contraction
    over the client axis on `device`.

    `q` is (N, R, row) int8, `s` is (N, R) f32 (host arrays or tensors).
    Returns the (R, row) f32 mean delta on the host. The aggregation
    weight folds into each client's scales first (``w_n * s_nr``), so the
    FedAvg server step is one einsum; with no weights the 1/N divides the
    sum. The einsum is a full-f32 product: nothing here enables TF32."""
    dev = resolve_device(device)
    if isinstance(q, np.ndarray):  # stack_deltas' buffer is read-only
        q = np.require(q, requirements="W")
    qf = torch.as_tensor(q, device=dev).to(torch.float32)
    st = torch.as_tensor(s, dtype=torch.float32, device=dev)
    if weights is None:
        out = torch.einsum("nr,nrc->rc", st, qf) / qf.shape[0]
    else:
        w = np.asarray(weights, np.float32)
        wt = torch.as_tensor(w / w.sum(), device=dev)
        out = torch.einsum("nr,nrc->rc", wt[:, None] * st, qf)
    return out.cpu().numpy()


# --------------------------------------------------------------------- #
# error feedback                                                         #
# --------------------------------------------------------------------- #
class ErrorFeedback:
    """Stateful compressor: residual accumulation per client."""

    def __init__(self, codec: Any):
        self.codec = codec
        self._residual: torch.Tensor | None = None
        self.bytes_sent = 0
        self.bytes_raw = 0

    def compress(self, flat: torch.Tensor) -> dict[str, Any]:
        if self._residual is not None:
            flat = flat + self._residual
        msg = self.codec.encode(flat)
        decoded = self.codec.decode(msg)
        self._residual = flat - decoded
        self.bytes_sent += self.codec.nbytes(msg)
        self.bytes_raw += int(flat.numel() * 4)
        return msg

    @property
    def compression_ratio(self) -> float:
        return self.bytes_raw / max(1, self.bytes_sent)
