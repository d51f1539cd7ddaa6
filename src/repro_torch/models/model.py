"""Decoder model built from an ArchConfig: plain functions over a
parameter dict, run eagerly.

An architecture is a sequence of *groups*; each group repeats a *pattern*
of LayerSpecs (mixer kind + attention window + FFN kind). The JAX package
stacks a group's layers on a leading `repeats` axis and scans over it; here
the parameters and the decode cache hold one entry per layer, in the order
the scan applies them (``for r in range(repeats): for spec in pattern``),
and the layers run in a Python loop:

    params = {"layers": [layer, ...], "final_norm": (d,),
              "embed": (V, d), "lm_head": (d, V) unless tied}
    layer  = {"norm1", "mixer", "norm2", "ffn": {"w_gate", "w_up", "w_down"}}
    mixer  = {"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]}            (attn)
           | {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
              "dt_bias", "A_log", "D", "out_proj"}                     (mamba)
    cache  = {"layers": [{"k", "v"} | {"ssm", "conv"}, ...], "position": int}

Weights keep the JAX layout `(d_in, d_out)`. `models.convert.params_from_jax`
carries a JAX parameter tree over.

Two entry points:
  * ``prefill``     — consume a prompt, return last-position logits + the
    decode cache;
  * ``decode_step`` — one token against the cache.
On the card the attention layers' prefill core is the flash kernel
(`attn_impl`) and the mamba layers' scan is the selective-scan kernel in
prefill and decode (`scan_impl`).

Attention and mamba mixers with dense FFNs are ported. The mLSTM and sLSTM
mixers and MoE FFNs raise `NotImplementedError`; training (`train_loss`)
is not ported (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models.layers import (
    Params,
    dense_init,
    embed,
    embed_init,
    logits_for_last,
    pad_to_multiple,
    rms_norm,
    rms_norm_init,
    swiglu,
    swiglu_init,
)

PENDING = ("{what} is not ported yet: ROADMAP queue 1 (training, MoE and xLSTM; "
           "MoE is what the full jamba config waits for)")


# --------------------------------------------------------------------- #
# configuration                                                         #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"  # attn | mamba | mlstm | slstm
    window: int | None = None  # sliding-window size for attn
    ffn: str = "dense"  # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    #: ((pattern, repeats), ...) — sum(len(p)*r) == n_layers
    groups: tuple[tuple[tuple[LayerSpec, ...], int], ...]
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_scan_dtype: str = "float32"
    n_codebooks: int = 1  # musicgen: 4 parallel heads
    frontend: str | None = None  # None | "vit_stub" | "encodec_stub"
    n_patches: int = 0  # vlm: patch embeddings prepended
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    param_dtype: str = "bfloat16"
    loss_chunk: int = 512
    mamba_chunk: int = 128
    attn_q_block: int = 512
    attn_kv_block: int = 512
    vocab_pad_multiple: int = 128
    #: the reference's TPU layout variant (repeat the KV heads to H before
    #: the attention core); config data only: the port's kernel maps query
    #: head h to KV head h // G itself, and the result is the same
    gqa_repeat: bool = False
    source: str = ""  # provenance note

    @property
    def n_layers(self) -> int:
        return sum(len(p) * r for p, r in self.groups)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def uses_embedding_input(self) -> bool:
        """Frontend-stub archs feed embeddings, not token ids."""
        return self.frontend == "encodec_stub"

    def layer_specs(self) -> list[LayerSpec]:
        out: list[LayerSpec] = []
        for pattern, repeats in self.groups:
            out.extend(list(pattern) * repeats)
        return out


def tiny_variant(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: shrink width/depth/
    experts/vocab while keeping the layer-pattern structure (the JAX
    package's `tiny_variant`, field for field)."""
    shrunk_groups = tuple((pattern, min(repeats, 1)) for pattern, repeats in cfg.groups)
    base = dataclasses.replace(
        cfg,
        name=cfg.name + "-tiny",
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        groups=shrunk_groups,
        moe_experts=min(cfg.moe_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_capacity_factor=4.0,
        n_patches=min(cfg.n_patches, 8),
        loss_chunk=64,
        mamba_chunk=16,
        attn_q_block=32,
        attn_kv_block=32,
        param_dtype="float32",
    )
    return dataclasses.replace(base, **overrides)


def _check_ported(spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "mamba"):
        raise NotImplementedError(PENDING.format(what=f"the {spec.mixer} mixer"))
    if spec.ffn == "moe":
        raise NotImplementedError(PENDING.format(what="the MoE FFN"))


# --------------------------------------------------------------------- #
# parameter init                                                        #
# --------------------------------------------------------------------- #
def _layer_init(gen: torch.Generator, spec: LayerSpec, cfg: ArchConfig) -> Params:
    _check_ported(spec)
    dev = gen.device
    if spec.mixer == "attn":
        mixer = attn.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.dtype, qk_norm=cfg.qk_norm)
    else:
        mixer = mam.mamba_init(gen, cfg.d_model, expand=cfg.mamba_expand,
                               d_state=cfg.mamba_d_state, d_conv=cfg.mamba_conv,
                               dtype=cfg.dtype)
    p: Params = {"norm1": rms_norm_init(cfg.d_model, dev), "mixer": mixer}
    if spec.ffn == "dense":
        p["norm2"] = rms_norm_init(cfg.d_model, dev)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters on `gen`'s device, drawn from `gen` with the
    reference's distributions (weights `normal·1/√d_in`, embeddings
    `normal·0.02`, norm scales zero). Not the reference's numbers: use
    `convert.params_from_jax` to carry a JAX tree over."""
    params: Params = {
        "layers": [_layer_init(gen, spec, cfg) for spec in cfg.layer_specs()],
        "final_norm": rms_norm_init(cfg.d_model, gen.device),
    }
    V = cfg.padded_vocab
    if cfg.uses_embedding_input:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.n_codebooks * V, cfg.dtype)
    else:
        params["embed"] = embed_init(gen, V, cfg.d_model, cfg.dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, V, cfg.dtype)
    return params


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_count(params: Params) -> int:
    return sum(x.numel() for x in _leaves(params))


def active_param_count(cfg: ArchConfig, params: Params) -> int:
    """Parameters touched per token (MoE: top_k of E experts)."""
    total = param_count(params)
    if cfg.moe_experts and cfg.moe_top_k:
        expert = sum(p["ffn"][name].numel()
                     for spec, p in zip(cfg.layer_specs(), params["layers"])
                     if spec.ffn == "moe" for name in ("w_gate", "w_up", "w_down"))
        return int(total - expert * (1 - cfg.moe_top_k / cfg.moe_experts))
    return total


# --------------------------------------------------------------------- #
# caches                                                                #
# --------------------------------------------------------------------- #
def cache_spec(cfg: ArchConfig, batch_size: int, cache_len: int) -> dict[str, Any]:
    """(shape, dtype) of every cache leaf, one entry per layer."""
    layers = []
    for spec in cfg.layer_specs():
        _check_ported(spec)
        if spec.mixer == "mamba":
            inner = cfg.mamba_expand * cfg.d_model
            layers.append({
                "ssm": ((batch_size, inner, cfg.mamba_d_state), torch.float32),
                "conv": ((batch_size, cfg.mamba_conv - 1, inner), cfg.dtype),
            })
            continue
        eff = min(spec.window, cache_len) if spec.window else cache_len
        kv = ((batch_size, eff, cfg.n_kv_heads, cfg.head_dim), cfg.dtype)
        layers.append({"k": kv, "v": kv})
    return {"layers": layers, "position": ((), torch.int32)}


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, *, device="cuda"):
    spec = cache_spec(cfg, batch_size, cache_len)
    layers = [{name: torch.zeros(shape, dtype=dt, device=device)
               for name, (shape, dt) in leaf.items()} for leaf in spec["layers"]]
    return {"layers": layers, "position": 0}


# --------------------------------------------------------------------- #
# prefill / decode                                                      #
# --------------------------------------------------------------------- #
def _input_hidden(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """(B, S, d) hidden states of the batch's tokens or embeddings."""
    if cfg.uses_embedding_input:  # musicgen: precomputed frame embeddings
        x = batch["frame_embeds"].to(cfg.dtype)
    elif cfg.frontend == "vit_stub":  # internvl: patches ++ text tokens
        x = torch.cat([batch["patch_embeds"].to(cfg.dtype),
                       embed(params["embed"], batch["tokens"])], dim=1)
    else:
        x = embed(params["embed"], batch["tokens"])
    return _scale_embeddings(cfg, x)


def _scale_embeddings(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma's ``x · √d``, with √d rounded to the param dtype as in the
    reference (a host scalar: no copy to the device)."""
    if not cfg.embed_scale:
        return x
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))


def _unembed_weight(params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg: ArchConfig, x_last: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x_last, params["final_norm"])
    logits = logits_for_last(x, _unembed_weight(params, cfg), valid_vocab=cfg.vocab_size)
    if cfg.n_codebooks > 1:
        logits = logits.reshape(x.shape[0], 1, cfg.n_codebooks, cfg.padded_vocab)
    return logits


def _ffn(p: Params, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.ffn == "none":
        return x
    return x + swiglu(p["ffn"], rms_norm(x, p["norm2"]))


def prefill(
    params: Params,
    cfg: ArchConfig,
    batch: dict[str, torch.Tensor],
    cache_len: int,
    *,
    attn_impl: Callable | None = None,
    scan_impl: Callable | None = None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Consume the prompt; return (last-token logits (B, 1, V) f32, decode
    cache). Positions run 0..S-1 for every row; nothing masks padding.
    `attn_impl` replaces the attention core (default: the flash kernel),
    `scan_impl` the mamba layers' scan (default: the selective-scan
    kernel)."""
    x = _input_hidden(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    caches = []
    for spec, p in zip(cfg.layer_specs(), params["layers"]):
        _check_ported(spec)
        h = rms_norm(x, p["norm1"])
        if spec.mixer == "mamba":
            y, c = mam.mamba_apply(p["mixer"], h, d_state=cfg.mamba_d_state,
                                   return_state=True, scan_impl=scan_impl)
        else:
            y, c = attn.attention_prefill(
                p["mixer"], h,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                positions=positions, rope_theta=cfg.rope_theta, window=spec.window,
                cache_len=cache_len, attn_impl=attn_impl,
            )
        x = _ffn(p, spec, x + y)
        caches.append(c)
    return _logits(params, cfg, x[:, -1:]), {"layers": caches, "position": S}


def decode_step(
    params: Params,
    cfg: ArchConfig,
    batch: dict[str, torch.Tensor],
    cache: dict[str, Any],
    *,
    scan_impl: Callable | None = None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """One token for every sequence in the batch. batch: {"tokens": (B, 1)}
    or {"frame_embeds": (B, 1, d)}. One scalar position serves the whole
    batch, as in the reference. Attention caches are updated in place, a
    mamba layer's state is replaced; returns (logits, cache with position +
    1). `scan_impl` replaces the mamba layers' scan (default: the kernel)."""
    position = int(cache["position"])
    if cfg.uses_embedding_input:
        x = batch["frame_embeds"].to(cfg.dtype)
    else:
        x = embed(params["embed"], batch["tokens"])
    x = _scale_embeddings(cfg, x)
    layers = []
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache["layers"]):
        _check_ported(spec)
        h = rms_norm(x, p["norm1"])
        if spec.mixer == "mamba":
            y, c = mam.mamba_decode(p["mixer"], h, c, d_state=cfg.mamba_d_state,
                                    scan_impl=scan_impl)
        else:
            y, c = attn.attention_decode(
                p["mixer"], h, c,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                position=position, rope_theta=cfg.rope_theta, window=spec.window,
            )
        x = _ffn(p, spec, x + y)
        layers.append(c)
    return _logits(params, cfg, x), {"layers": layers, "position": position + 1}
