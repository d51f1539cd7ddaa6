"""The port's flash attention (`repro_torch.kernels.flash_attention`)
against the JAX package's oracle `flash_attention_ref` and its Pallas
kernel in interpret mode (where S is a multiple of the Pallas blocks).

Inputs come from numpy with fixed seeds. Tolerances are the JAX package's
own for this kernel (tests/test_kernels.py): atol 2e-5 in f32, 3e-2 in
bf16 (the output is rounded to bf16, a relative step of 2^-8).

On the CPU the wrapper runs the plain version. The tests marked `cuda`
hold the CUDA kernel against the plain version on the card, causal and
not, and skip where there is no card; bf16 runs the tensor-core kernel,
f32 the CUDA-core one. Their bf16 tolerance is tighter
than the JAX package's: both sides round the same f32 value (up to the
order of f32 sums) to bf16, so they may part by one bf16 step, at most
2^-7 of the value, plus the f32 tolerance; an absolute 3e-2 is as large
as the outputs themselves at long S.

A CPU test emulates the tensor-core kernel's arithmetic (P·V as bf16
products over P sliced into three bf16 terms) and holds it to that bf16
tolerance.
"""
import math

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


#: the tensor-core kernel's key tile; its query tile is 64 rows, 64 / P
#: positions of P heads of a KV group (P the largest power of two in G)
TILE = 64
TC_CASES = [  # B, S, H, KV, D, window: bf16 only
    (1, 1, 4, 1, 64, None), (1, TILE - 1, 4, 1, 64, None), (1, TILE, 4, 1, 64, None),
    (1, TILE + 1, 4, 1, 64, None), (1, 2 * TILE + 1, 4, 1, 64, None),
    (2, TILE + 1, 2, 2, 128, None), (1, 2 * TILE + 1, 3, 1, 128, None),  # G = 1, G = 3
    (1, 200, 8, 2, 64, 40), (1, 300, 4, 4, 128, 96),  # windows ending mid-tile
    (1, 130, 8, 1, 32, None), (1, 130, 16, 2, 120, None), (1, 100, 8, 1, 256, None),  # G = 8
    (4, 8, 32, 8, 128, None), (4, 48, 32, 8, 128, None),  # the serve prefill
    (1, 65, 4, 2, 20, None),  # D not a multiple of 8: padded for TMA
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,window", TC_CASES)
def test_tensor_core_kernel_matches_plain_version_at_its_tile_edges(cuda, B, S, H, KV, D,
                                                                    window):
    _, (tq, tk, tv) = inputs(B, S, H, KV, D, "bf16", seed=6)
    tq, tk, tv = tq.to(cuda), tk.to(cuda), tv.to(cuda)
    before = fa.launches
    got = fa.flash_attention(tq, tk, tv, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(as_f32(got.cpu()), as_f32(want.cpu()), **CARD_TOL["bf16"])


@pytest.mark.cuda
def test_tensor_core_kernel_takes_a_misaligned_start(cuda):
    _, (tq, tk, tv) = inputs(1, 70, 4, 2, 64, "bf16", seed=7)
    tq, tk, tv = tq.to(cuda), tk.to(cuda), tv.to(cuda)
    # a contiguous view 2 bytes into its storage: TMA needs 16-byte starts
    shifted = torch.empty(tq.numel() + 1, dtype=tq.dtype, device=cuda)[1:].view(tq.shape)
    shifted.copy_(tq)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = fa.flash_attention(shifted, tk, tv)
    want = fa.flash_attention_plain(tq, tk, tv)
    np.testing.assert_allclose(as_f32(got.cpu()), as_f32(want.cpu()), **CARD_TOL["bf16"])


def test_tma_ready_pads_with_zero_columns_and_realigns():
    x = torch.arange(2 * 3 * 20, dtype=torch.float32).reshape(1, 2, 3, 20).to(torch.bfloat16)
    padded = fa._tma_ready(x, 24)
    assert padded.shape == (1, 2, 3, 24) and padded.is_contiguous()
    assert torch.equal(padded[..., :20], x) and not padded[..., 20:].any()
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    shifted.copy_(x)
    moved = fa._tma_ready(shifted, 20)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x)
    assert fa._tma_ready(padded, 24) is padded  # aligned and wide enough: as it is


def bf16_slice(x: torch.Tensor) -> torch.Tensor:
    """The top 8 bits of each f32 significand (a bf16 value, exact)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def emulate_tensor_core_kernel(q, k, v, *, causal, window, terms=3):
    """The bf16 kernel's arithmetic in torch on the CPU: per 64-key tile,
    S = Q·Kᵀ from bf16 values with f32 sums, times D^-½ in f32, masked to
    -1e30; the online softmax in f32 (m, l, exp, the rescale); P·V
    as f32 sums over P's first `terms` bf16 slices (top, middle and bottom
    8 bits of the significand; the kernel takes all three); the output
    acc / max(l, 1e-30), rounded to bf16 once."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, D)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    live = fa._mask(S, causal, window, q.device)
    m = torch.full((B, KV, H // KV, S), fa.NEG_INF)
    l = torch.zeros((B, KV, H // KV, S))
    acc = torch.zeros((B, KV, H // KV, S, D))
    for k0 in range(0, S, TILE):
        keys = slice(k0, min(k0 + TILE, S))
        s = torch.einsum("btkgd,bskd->bkgts", qf, kf[:, keys]) * scale
        s = s.masked_fill(~live[:, keys], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv, rest = 0.0, p
        for _ in range(terms):
            term = bf16_slice(rest)
            pv = pv + torch.einsum("bkgts,bskd->bkgtd", term, vf[:, keys])
            rest = rest - term
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(torch.bfloat16)


def err_over_card_tol(got, want):
    tol = CARD_TOL["bf16"]
    diff = (got.float() - want.float()).abs()
    return float((diff / (tol["atol"] + tol["rtol"] * want.float().abs())).max())


@pytest.mark.parametrize("B,S,H,KV,D,window,causal", [
    (1, 256, 4, 1, 64, None, True),
    (1, 300, 4, 2, 128, 100, True),
    (1, 1024, 2, 1, 128, None, True),
])
def test_split_p_keeps_the_emulated_kernel_within_one_bf16_step(B, S, H, KV, D, window,
                                                                  causal):
    _, (tq, tk, tv) = inputs(B, S, H, KV, D, "bf16", seed=8)
    want = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    over = {terms: err_over_card_tol(emulate_tensor_core_kernel(
        tq, tk, tv, causal=causal, window=window, terms=terms), want) for terms in (1, 2, 3)}
    # measured here: three slices (the kernel) at 0.73-0.94 of the bound, two
    # at 0.93-0.98, P cut once to bf16 at 46-71 times it
    assert over[3] <= 1.0 and over[2] <= 1.0
    assert over[1] > 10.0
