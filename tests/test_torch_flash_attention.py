"""The port's flash attention (`repro_torch.kernels.flash_attention`)
against the JAX package's oracle `flash_attention_ref` and its Pallas
kernel in interpret mode (where S is a multiple of the Pallas blocks).

Inputs come from numpy with fixed seeds. Tolerances are the JAX package's
own for this kernel (tests/test_kernels.py): atol 2e-5 in f32, 3e-2 in
bf16 (the output is rounded to bf16, a relative step of 2^-8).

On the CPU the wrapper runs the plain version. The tests marked `cuda`
hold the CUDA kernel against the plain version on the card, causal and
not, and skip where there is no card. Their bf16 tolerance is tighter
than the JAX package's: both sides round the same f32 value (up to the
order of f32 sums) to bf16, so they may part by one bf16 step, at most
2^-7 of the value, plus the f32 tolerance; an absolute 3e-2 is as large
as the outputs themselves at long S.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

CASES = [  # B, S, H, KV, D, window
    (2, 64, 4, 4, 64, None),     # G = 1, causal
    (1, 64, 8, 2, 64, None),     # G = 4
    (1, 128, 8, 2, 64, 48),      # window < S
    (1, 64, 4, 1, 64, 200),      # window >= S masks nothing more
    (2, 47, 8, 2, 64, None),     # ragged S
    (1, 47, 4, 1, 120, 16),      # danube's head_dim, ragged, windowed
    (1, 64, 4, 1, 256, None),    # gemma3's head_dim
    (1, 33, 4, 4, 256, 8),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (None, jnp.bfloat16, torch.bfloat16, 3e-2)}


def inputs(B, S, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng([B, S, H, KV, D, seed])
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    _, jdt, tdt, _ = DTYPES[dtype]
    jax_in = [jnp.asarray(a, jdt) for a in arrays]
    # the same values on both sides: bf16 rounding is done once, by jax
    torch_in = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in jax_in]
    return jax_in, torch_in


def as_f32(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D,window", CASES)
def test_plain_matches_flash_attention_ref(B, S, H, KV, D, window, dtype):
    (q, k, v), (tq, tk, tv) = inputs(B, S, H, KV, D, dtype)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, D)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=DTYPES[dtype][3])


@pytest.mark.parametrize("B,S,H,KV,D,window", [c for c in CASES if c[1] % 32 == 0])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(B, S, H, KV, D, window):
    (q, k, v), (tq, tk, tv) = inputs(B, S, H, KV, D, "f32", seed=1)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    want = pallas_flash(q, k, v, causal=True, window=window, block_q=32, block_k=32,
                        interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=2e-5)


def test_non_causal_matches_flash_attention_ref():
    (q, k, v), (tq, tk, tv) = inputs(1, 40, 4, 2, 64, "f32", seed=2)
    for window in (None, 9):
        got = fa.flash_attention_plain(tq, tk, tv, causal=False, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=False, window=window)
        np.testing.assert_allclose(as_f32(got), as_f32(want), atol=2e-5)


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    _, (tq, tk, tv) = inputs(1, 47, 4, 1, 64, "f32", seed=3)
    before = fa.launches
    got = ops.flash_attention(tq, tk, tv, window=16)
    assert torch.equal(got, fa.flash_attention_plain(tq, tk, tv, window=16))
    assert fa.launches == before  # the plain version launches nothing


def test_the_wrapper_refuses_other_devices():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])


# --------------------------------------------------------------------- #
# on the card                                                            #
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU path)")
    return torch.device("cuda")


CARD_CASES = CASES + [(4, 48, 32, 8, 128, None), (1, 300, 8, 8, 32, 100), (2, 1000, 8, 2, 128, 128),
                     (4, 47, 64, 8, 128, None), (1, 300, 16, 2, 64, 100)]  # G = 8 (jamba)
NON_CAUSAL_CASES = [(1, 40, 4, 2, 64, None), (1, 40, 4, 2, 64, 9), (2, 130, 4, 4, 120, None),
                    (1, 300, 8, 2, 128, 100)]
#: kernel against plain version on the card (see the module docstring)
CARD_TOL = {"f32": dict(atol=2e-5, rtol=0.0), "bf16": dict(atol=2e-5, rtol=2**-7)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D,window", CARD_CASES)
def test_kernel_matches_plain_version_on_the_card(cuda, B, S, H, KV, D, window, dtype):
    _, (tq, tk, tv) = inputs(B, S, H, KV, D, dtype, seed=4)
    tq, tk, tv = tq.to(cuda), tk.to(cuda), tv.to(cuda)
    before = fa.launches
    got = fa.flash_attention(tq, tk, tv, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(as_f32(got.cpu()), as_f32(want.cpu()), **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D,window", NON_CAUSAL_CASES)
def test_non_causal_kernel_matches_plain_version_on_the_card(cuda, B, S, H, KV, D, window,
                                                             dtype):
    _, (tq, tk, tv) = inputs(B, S, H, KV, D, dtype, seed=5)
    tq, tk, tv = tq.to(cuda), tk.to(cuda), tv.to(cuda)
    got = fa.flash_attention(tq, tk, tv, causal=False, window=window)
    want = fa.flash_attention_plain(tq, tk, tv, causal=False, window=window)
    np.testing.assert_allclose(as_f32(got.cpu()), as_f32(want.cpu()), **CARD_TOL[dtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 8, 2, 512), device=cuda)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, torch.zeros((1, 8, 3, 64), device=cuda), torch.zeros((1, 8, 3, 64), device=cuda))
