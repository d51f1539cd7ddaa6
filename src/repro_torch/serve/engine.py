"""LLM serving engine: batched prefill + decode over the model substrate.

Requests are admitted into a fixed-size decode batch, prefilled, decoded
for their token budget, and the next wave is admitted when the batch is
done. Everything runs eagerly on the device the parameters live on (the
card, unless they were made on the CPU); there the prefill's attention core
is the flash-attention kernel and the mamba layers' scan (prefill and
decode) the selective-scan kernel. Greedy or temperature sampling.

As in the JAX package's engine: a wave's prompts are left-padded with
token 0 to a common length and nothing masks the padding (padded
positions are attended, and positions run 0..S-1 for every row), and one
scalar position serves the whole batch in decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.model import ArchConfig, decode_step, prefill


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: np.ndarray  # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0
    tokens_out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Static-batch engine (one prefill per batch; `serve_loop` below
    admits waves of requests). `attn_impl` replaces the prefill's
    attention core (default: `ops.flash_attention`), `scan_impl` the mamba
    layers' scan (default: `ops.ssm_scan`)."""

    def __init__(self, cfg: ArchConfig, params: Any, *, cache_len: int,
                 attn_impl: Callable | None = None, scan_impl: Callable | None = None):
        self.cfg = cfg
        self.params = params
        self.cache_len = cache_len
        self.attn_impl = attn_impl
        self.scan_impl = scan_impl
        self.device = params["final_norm"].device

    def _sample(self, logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        logits = logits[:, -1]  # (B, V) or (B, K, V)
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
        probs = torch.softmax(logits / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=gen).reshape(probs.shape[:-1])

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,  # (B, S) int
        *,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """Greedy/temperature generation for a full batch: (B, new) tokens.
        Temperature sampling draws from a `torch.Generator` seeded with
        `seed`; it does not reproduce jax.random's draws."""
        B = prompts.shape[0]
        tokens = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        logits, cache = prefill(self.params, self.cfg, {"tokens": tokens}, self.cache_len,
                                attn_impl=self.attn_impl, scan_impl=self.scan_impl)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs = []
        tok = self._sample(logits, temperature, gen)
        for _ in range(max_new_tokens):
            outs.append(tok)
            logits, cache = decode_step(self.params, self.cfg, {"tokens": tok.reshape(B, 1)},
                                        cache, scan_impl=self.scan_impl)
            tok = self._sample(logits, temperature, gen)
        return torch.stack(outs, dim=1).cpu().numpy()  # (B, new)


def serve_loop(
    engine: ServeEngine,
    requests: list[Request],
    *,
    batch_size: int = 4,
    seed: int = 0,
) -> dict[str, list[int]]:
    """Minimal continuous-batching scheduler: admit up to `batch_size`
    requests per wave (left-padded to a common prompt length), decode, and
    admit the next wave when the batch is done."""
    pending = list(requests)
    results: dict[str, list[int]] = {}
    wave = 0
    while pending:
        batch_reqs = pending[:batch_size]
        pending = pending[batch_size:]
        S = max(r.prompt.shape[0] for r in batch_reqs)
        prompts = np.stack([np.pad(r.prompt, (S - r.prompt.shape[0], 0))  # left-pad
                            for r in batch_reqs])
        new = engine.generate(
            prompts,
            max_new_tokens=max(r.max_new_tokens for r in batch_reqs),
            temperature=batch_reqs[0].temperature,
            seed=seed + wave,
        )
        for i, r in enumerate(batch_reqs):
            results[r.request_id] = [int(t) for t in new[i, : r.max_new_tokens]]
            r.tokens_out = results[r.request_id]
            r.done = True
        wave += 1
    return results
