"""The port's decoder (`repro_torch.models`) against the JAX package's, on
the CPU, with the JAX weights carried over by `params_from_jax`.

Both sides run f32 at tiny configs (qwen3-4b, granite-8b, gemma3-1b, two
windowed variants, and jamba's hybrid block with its MoE FFNs made dense);
the port's attention core on the CPU is the flash kernel's plain version,
its mamba scan the selective-scan kernel's. The inputs come from numpy
with fixed seeds.

Tolerances: logits and caches at atol = rtol = 1e-4. Both sides compute in
f32 and the products, softmax and norms sum in different orders (XLA's
blocked online softmax against one materialised softmax), so the last bits
differ; 1e-4 is far above that (observed up to 3e-6) and far below any
difference a wrong layer order, mask, rope or cache slot makes (order 0.1–1).
Norms and rope at atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_tiny as ref_get_tiny
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch.configs import ARCH_IDS, get_config, get_tiny
from repro_torch.models import attention, layers, model
from repro_torch.models.convert import cache_from_jax, params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)


def port_cfg(ref_cfg) -> model.ArchConfig:
    """The port's ArchConfig with the same fields as a reference one."""
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["groups"] = tuple(
        (tuple(model.LayerSpec(**dataclasses.asdict(s)) for s in pattern), r)
        for pattern, r in ref_cfg.groups)
    return model.ArchConfig(**fields)


def expert_free(cfg):
    """A config with every MoE FFN replaced by a dense SwiGLU of one
    expert's width (jamba's hybrid block without experts)."""
    groups = tuple((tuple(dataclasses.replace(s, ffn="dense") for s in pattern), r)
                   for pattern, r in cfg.groups)
    return dataclasses.replace(cfg, groups=groups)


def windowed(name: str, window: int, repeats: tuple) -> object:
    """A tiny reference config whose local layers have `window` (global
    layers stay global) and whose groups repeat `repeats` times."""
    cfg = ref_get_tiny(name)
    groups = tuple(
        (tuple(dataclasses.replace(s, window=window if s.window else None) for s in pattern), r)
        for (pattern, _), r in zip(cfg.groups, repeats, strict=True))
    return dataclasses.replace(cfg, groups=groups)


CASES = {
    "qwen3-4b": lambda: ref_get_tiny("qwen3-4b"),
    "granite-8b": lambda: ref_get_tiny("granite-8b"),
    "gemma3-1b": lambda: ref_get_tiny("gemma3-1b"),
    # (5 local + 1 global) x 2 + 2 local, local window 4: local attention,
    # rolling caches beside global ones, and the scan's repeat order
    "gemma3-1b-w4x2": lambda: windowed("gemma3-1b", 4, (2, 1)),
    "h2o-danube-3-4b-w4": lambda: windowed("h2o-danube-3-4b", 4, (2,)),
    # 7 mamba layers and attention at in-block index 4 (no rope), dense FFNs
    "jamba-1.5-large-398b-dense": lambda: expert_free(ref_get_tiny("jamba-1.5-large-398b")),
}


def build(case, seed=0):
    ref_cfg = CASES[case]()
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    cfg = port_cfg(ref_cfg)
    return ref_cfg, params, cfg, params_from_jax(cfg, tree, device="cpu")


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_configs_are_the_references(name):
    assert get_config(name) == port_cfg(ref_get_config(name))
    assert get_tiny(name) == port_cfg(ref_get_tiny(name))
    assert get_tiny(name).dtype == torch.float32 and get_config(name).dtype == torch.bfloat16


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    scale = (rng.standard_normal(32) * 0.1).astype(np.float32)
    close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
          ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), atol=1e-5, rtol=1e-5)
    pos = np.arange(7)[None, :] + 3
    for theta in (10_000.0, 1_000_000.0):
        close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
              ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 4, 64])
@pytest.mark.parametrize("gqa_repeat", [False, True])
def test_attention_apply_matches(window, gqa_repeat):
    """The port has one GQA layout; the reference's `gqa_repeat` variant
    (KV heads repeated before the core) must give the same result."""
    rng = np.random.default_rng(1)
    d, H, KV, D, S = 64, 4, 2, 16, 11
    w = {n: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
         for n, shape in (("wq", (d, H * D)), ("wk", (d, KV * D)), ("wv", (d, KV * D)),
                          ("wo", (H * D, d)))}
    w["q_norm"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    w["k_norm"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=D, rope_theta=10_000.0, window=window)
    got = attention.attention_apply({k: torch.from_numpy(v) for k, v in w.items()},
                                    torch.from_numpy(x), positions=torch.arange(S), **kw)
    want = ref_attn.attention_apply({k: jnp.asarray(v) for k, v in w.items()},
                                    jnp.asarray(x), positions=jnp.arange(S),
                                    gqa_repeat=gqa_repeat, **kw)
    close(got, want)


@pytest.mark.parametrize("window", [None, 5])
def test_reference_attention_and_repeat_kv_match(window):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    got = attention.reference_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    close(got, ref_attn.reference_attention(*map(jnp.asarray, (q, k, v)), window=window))
    assert np.array_equal(attention.repeat_kv(torch.from_numpy(k), 4).numpy(),
                          np.asarray(ref_attn.repeat_kv(jnp.asarray(k), 4)))


@pytest.mark.parametrize("case", ["qwen3-4b", "gemma3-1b-w4x2", "jamba-1.5-large-398b-dense"])
def test_cache_spec_and_init_cache_match(case):
    ref_cfg = CASES[case]()
    cfg = port_cfg(ref_cfg)
    ref_spec = ref_model.cache_spec(ref_cfg, 3, 16)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref_spec,
                         is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))
    want = cache_from_jax(cfg, zeros, device="cpu")
    spec = model.cache_spec(cfg, 3, 16)
    cache = model.init_cache(cfg, 3, 16, device="cpu")
    assert cache["position"] == want["position"] == 0
    for s_leaf, c_leaf, w_leaf in zip(spec["layers"], cache["layers"], want["layers"]):
        assert sorted(s_leaf) == sorted(c_leaf) == sorted(w_leaf)
        for name in w_leaf:
            assert s_leaf[name] == (tuple(w_leaf[name].shape), w_leaf[name].dtype)
            assert torch.equal(c_leaf[name], w_leaf[name])


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def check_cache(cfg, got, ref_cache):
    want = cache_from_jax(cfg, jax.tree.map(np.asarray, ref_cache), device="cpu")
    assert got["position"] == want["position"]
    assert len(got["layers"]) == len(want["layers"]) == cfg.n_layers
    for g, w in zip(got["layers"], want["layers"]):
        assert sorted(g) == sorted(w)
        for leaf in w:
            assert g[leaf].shape == w[leaf].shape and g[leaf].dtype == w[leaf].dtype
            close(g[leaf], w[leaf])


@pytest.mark.parametrize("case,S,cache_len", [(c, 13, 16) for c in sorted(CASES)] + [
    ("qwen3-4b", 21, 16), ("h2o-danube-3-4b-w4", 21, 16)])
def test_prefill_and_decode_match(case, S, cache_len):
    """Prefill's last logits and every cache leaf, then 4 teacher-forced
    decode steps' logits and caches. S = 21 > cache_len also runs the
    clamped cache write of global layers (qwen3) and a windowed prefill
    longer than its window (danube)."""
    ref_cfg, ref_params, cfg, params = build(case)
    prompt = tokens(cfg, 2, S, seed=S)
    logits, cache = model.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)}, cache_len)
    ref_logits, ref_cache = ref_model.prefill(ref_params, ref_cfg,
                                              {"tokens": jnp.asarray(prompt)}, cache_len)
    assert logits.shape == ref_logits.shape == (2, 1, cfg.padded_vocab)
    close(logits, ref_logits)
    check_cache(cfg, cache, ref_cache)
    decode = jax.jit(lambda p, b, c: ref_model.decode_step(p, ref_cfg, b, c))
    forced = tokens(cfg, 2, 4, seed=S + 1)
    for t in range(4):
        tok = forced[:, t:t + 1]
        logits, cache = model.decode_step(params, cfg, {"tokens": torch.from_numpy(tok)}, cache)
        ref_logits, ref_cache = decode(ref_params, {"tokens": jnp.asarray(tok)}, ref_cache)
        close(logits, ref_logits)
    check_cache(cfg, cache, ref_cache)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_embedding_frontends_match(arch):
    """musicgen feeds frame embeddings and has 4 codebook heads; internvl
    prepends patch embeddings to the text tokens."""
    ref_cfg = ref_get_tiny(arch)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(3))
    cfg = port_cfg(ref_cfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    rng = np.random.default_rng(3)
    if cfg.uses_embedding_input:
        batch = {"frame_embeds": rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)}
        step = {"frame_embeds": rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"patch_embeds": rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32),
                 "tokens": tokens(cfg, 2, 6, seed=3)}
        step = {"tokens": tokens(cfg, 2, 1, seed=4)}
    logits, cache = model.prefill(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, 32)
    ref_logits, ref_cache = ref_model.prefill(ref_params, ref_cfg,
                                              {k: jnp.asarray(v) for k, v in batch.items()}, 32)
    assert logits.shape == ref_logits.shape
    close(logits, ref_logits)
    logits, cache = model.decode_step(params, cfg, {k: torch.from_numpy(v) for k, v in step.items()},
                                      cache)
    ref_logits, ref_cache = ref_model.decode_step(ref_params, ref_cfg,
                                                  {k: jnp.asarray(v) for k, v in step.items()},
                                                  ref_cache)
    close(logits, ref_logits)
    check_cache(cfg, cache, ref_cache)


def test_windowed_cache_slot_fault_is_reproduced():
    """After a prompt longer than the window whose length is no multiple
    of it, decode writes the next key over a slot that is not the oldest
    (the reference's `attention_prefill` keeps the last `eff` keys in
    order, `attention_decode` writes at `position % Smax`). The port
    reproduces the reference, and both differ from a full prefill of the
    same S + 1 tokens."""
    ref_cfg, ref_params, cfg, params = build("h2o-danube-3-4b-w4")
    S, cache_len = 6, 16
    seq = tokens(cfg, 1, S + 1, seed=7)
    _, cache = model.prefill(params, cfg, {"tokens": torch.from_numpy(seq[:, :S])}, cache_len)
    got, _ = model.decode_step(params, cfg, {"tokens": torch.from_numpy(seq[:, S:])}, cache)
    _, ref_cache = ref_model.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(seq[:, :S])},
                                     cache_len)
    want, _ = ref_model.decode_step(ref_params, ref_cfg, {"tokens": jnp.asarray(seq[:, S:])},
                                    ref_cache)
    full, _ = ref_model.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(seq)}, cache_len)
    close(got, want)
    assert float(np.abs(np.asarray(want) - np.asarray(full)).max()) > 0.1
    assert float(np.abs(got.numpy() - np.asarray(full)).max()) > 0.1


def test_flat_layer_order_follows_the_scan():
    """Layer `offset + r * len(pattern) + i` of the port is the JAX
    stack's group entry [str(i)][r]."""
    ref_cfg, ref_params, cfg, params = build("gemma3-1b-w4x2")
    assert [s.window for s in cfg.layer_specs()] == [4] * 5 + [None] + [4] * 5 + [None] + [4, 4]
    flat = 0
    for (pattern, repeats), group in zip(ref_cfg.groups, ref_params["groups"]):
        for r in range(repeats):
            for i in range(len(pattern)):
                want = np.asarray(group[str(i)]["mixer"]["wq"][r])
                assert np.array_equal(params["layers"][flat]["mixer"]["wq"].numpy(), want)
                flat += 1
    assert flat == len(params["layers"]) == 14


def test_param_counts_and_init_distributions():
    ref_cfg, ref_params, cfg, params = build("gemma3-1b")
    assert model.param_count(params) == ref_model.param_count(ref_params)
    assert model.active_param_count(cfg, params) == ref_model.active_param_count(ref_cfg, ref_params)
    mine = model.init_params(cfg, torch.Generator().manual_seed(0))
    assert model.param_count(mine) == model.param_count(params)
    wq = mine["layers"][0]["mixer"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(mine["embed"].std()) - 0.02) < 0.002
    assert float(mine["final_norm"].abs().max()) == 0.0


def test_params_from_jax_keeps_the_mamba_leaves_dtypes():
    """In a bf16 jamba cut, the mamba mixer's bf16 leaves come over bit for
    bit and its f32 leaves (conv_b, dt_bias, A_log, D) stay f32; the decode
    cache's ssm state is f32 and its conv tail bf16, as the reference's."""
    ref_cfg = dataclasses.replace(CASES["jamba-1.5-large-398b-dense"](), param_dtype="bfloat16")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(4))
    cfg = port_cfg(ref_cfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    mixer = params["layers"][0]["mixer"]
    ref_mixer = ref_params["groups"][0]["0"]["mixer"]
    assert sorted(mixer) == sorted(ref_mixer)
    for name, leaf in ref_mixer.items():
        want = np.asarray(leaf[0])
        assert str(mixer[name].dtype).split(".")[1] == str(want.dtype), name
        assert np.array_equal(mixer[name].view(torch.int16 if want.dtype.itemsize == 2
                                                 else torch.int32).numpy(),
                              want.view(np.int16 if want.dtype.itemsize == 2 else np.int32)), name
    assert {n for n, v in mixer.items() if v.dtype == torch.float32} == {
        "conv_b", "dt_bias", "A_log", "D"}
    spec = model.cache_spec(cfg, 2, 8)["layers"][0]
    assert spec == {"ssm": ((2, 256, 16), torch.float32), "conv": ((2, 3, 256), torch.bfloat16)}


def test_jamba_cut_param_count_matches():
    ref_cfg, ref_params, cfg, params = build("jamba-1.5-large-398b-dense")
    mine = model.init_params(cfg, torch.Generator().manual_seed(0))
    assert model.param_count(mine) == model.param_count(params) == ref_model.param_count(ref_params)
    assert [s.mixer for s in cfg.layer_specs()] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3


#: what each tiny config meets first that the port does not have
UNPORTED = {"jamba-1.5-large-398b": "the MoE FFN", "xlstm-1.3b": "the mlstm mixer",
            "granite-moe-1b-a400m": "the MoE FFN"}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b", "granite-moe-1b-a400m"])
def test_unported_mixers_and_moe_raise_the_named_error(arch):
    """jamba's mamba layers are ported: its tiny config gets past them and
    stops at its first MoE FFN (in-block index 1)."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1") as err:
        model.init_params(get_tiny(arch), torch.Generator().manual_seed(0))
    assert str(err.value).startswith(f"{UNPORTED[arch]} is not ported yet")
