"""The port's LLM serving engine (`repro_torch.serve.engine`) against the
JAX package's, on the CPU, with the JAX weights carried over by
`params_from_jax`, and the `--llm` mode of the port's launcher.

Greedy tokens must be equal, token for token: both sides take the first
maximum of f32 logits that agree within 1e-4 (tests/test_torch_models.py).
Besides the attention-only configs, jamba's hybrid block with its MoE FFNs
made dense runs through both engines: its mamba layers carry their state
from the prefill into every decode step.
No seed here lands on an argmax near-tie; had one done so, the test would
compare that step's logits instead, and say so.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_tiny as ref_get_tiny
from repro.models import init_params as ref_init_params
from repro.serve import engine as ref_engine
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine, serve_loop

from test_torch_models import expert_free

ROOT = Path(__file__).resolve().parents[1]


def engines(arch, seed, cache_len=64):
    ref_cfg = ref_get_tiny(arch)
    if arch == "jamba-1.5-large-398b":
        ref_cfg = expert_free(ref_cfg)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["groups"] = tuple(
        (tuple(model.LayerSpec(**dataclasses.asdict(s)) for s in p), r) for p, r in ref_cfg.groups)
    cfg = model.ArchConfig(**fields)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return (ServeEngine(cfg, params, cache_len=cache_len),
            ref_engine.ServeEngine(ref_cfg, ref_params, cache_len=cache_len))


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-8b"])
def test_generate_matches_reference(arch):
    eng, ref = engines(arch, seed=0)
    prompts = np.random.default_rng(0).integers(0, eng.cfg.vocab_size, (3, 16))
    got = eng.generate(prompts, max_new_tokens=6)
    assert got.shape == (3, 6)
    assert np.array_equal(got, ref.generate(prompts, max_new_tokens=6))
    assert np.array_equal(got, eng.generate(prompts, max_new_tokens=6))


def requests(vocab, lengths, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", rng.integers(0, vocab, (int(n),)), max_new_tokens=4)
            for i, n in enumerate(lengths)]


def test_serve_loop_on_the_jamba_cut_matches_the_reference():
    """Greedy `serve_loop` tokens of the hybrid cut equal the JAX
    engine's, with the waves' left padding unmasked in both (the
    reference's fault, reproduced: the padding runs through the mamba
    state and the attention alike)."""
    eng, ref = engines("jamba-1.5-large-398b", seed=4)
    assert {s.mixer for s in eng.cfg.layer_specs()} == {"mamba", "attn"}
    lengths = [9, 14, 6]  # one wave: two prompts left-padded
    got = serve_loop(eng, requests(eng.cfg.vocab_size, lengths, 4, Request), batch_size=3)
    want = ref_engine.serve_loop(ref, requests(eng.cfg.vocab_size, lengths, 4, ref_engine.Request),
                                 batch_size=3)
    assert got == want and all(len(v) == 4 for v in got.values())
    # the padding is not masked: the short prompt of a wave answers
    # otherwise than alone
    alone = serve_loop(eng, requests(eng.cfg.vocab_size, lengths, 4, Request)[2:3], batch_size=1)
    assert alone["r2"] != got["r2"]


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-8b"])
def test_serve_loop_handles_mixed_requests_as_the_reference(arch):
    """Mixed prompt lengths, left-padded per wave without a mask, as in
    the reference's `test_serve_loop_handles_mixed_requests`."""
    eng, ref = engines(arch, seed=1)
    lengths = [8, 12, 16, 8, 12]
    reqs = requests(eng.cfg.vocab_size, lengths, 1, Request)
    got = serve_loop(eng, reqs, batch_size=2)
    want = ref_engine.serve_loop(ref, requests(eng.cfg.vocab_size, lengths, 1, ref_engine.Request),
                                 batch_size=2)
    assert got == want
    assert set(got) == {f"r{i}" for i in range(5)} and all(len(v) == 4 for v in got.values())
    assert all(r.done and r.tokens_out == got[r.request_id] for r in reqs)


def test_temperature_sampling_is_seeded():
    eng, _ = engines("qwen3-4b", seed=2)
    prompts = np.random.default_rng(2).integers(0, eng.cfg.vocab_size, (2, 8))
    a = eng.generate(prompts, max_new_tokens=5, temperature=1.0, seed=3)
    assert np.array_equal(a, eng.generate(prompts, max_new_tokens=5, temperature=1.0, seed=3))
    assert a.shape == (2, 5) and (a < eng.cfg.vocab_size).all()


def test_launch_serve_llm_on_the_cpu_replays():
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--llm", "--device", "cpu",
            "--requests", "5", "--max-new", "3", "--batch-size", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = [subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120) for _ in range(2)]
    for res in outs:
        assert res.returncode == 0, res.stderr
    a, b = (res.stdout.splitlines() for res in outs)
    assert a[0].startswith("5 requests -> 15 tokens in ")  # the timing line
    assert a[1:] == b[1:] and [ln.split()[0] for ln in a[1:]] == [f"req-{i}" for i in range(5)]
