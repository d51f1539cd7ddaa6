"""The port's sketch merges (`repro_torch.kernels.ops`) against the JAX
package's (`repro.kernels.ops`) and the sequential Chan merge.

Tolerances: pooled counts, histograms and the merged quantile values and
cumulative weights are exact (integer sums; a stable co-sort in both
packages; the same f32 weights summed in float64 in the same order).
Mean and M2 are f32 sums whose order differs between XLA and torch, so
they agree to 1e-6 relative. Against the float64 sequential reference
(`merge_moments_reference`) the f32 reductions hold 1e-5 relative, the
bound the JAX package's own merge is tested to.
"""
import numpy as np
import pytest

from repro.fleet.analytics import merge_moments_reference
from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops


def random_sketches(seed, n, K, bins):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 65, n).astype(np.float32)
    counts[: max(1, n // 8)] = 0  # count-0 vehicles
    means = rng.normal(5.0, 2.0, n).astype(np.float32)
    means[counts == 0] = 0.0
    m2s = (rng.gamma(2.0, 3.0, n) * counts).astype(np.float32)
    hists = rng.multinomial(64, np.ones(bins) / bins, n).astype(np.int64)
    qvals = np.sort(rng.normal(5.0, 2.0, (n, K)).astype(np.float32), axis=1)
    qvals = np.round(qvals, 1)  # ties across vehicles, so sort stability shows
    qvals[counts == 0] = np.nan
    return counts, means, m2s, hists, qvals


@pytest.mark.parametrize("seed,n,K,bins", [(0, 1, 1, 1), (1, 40, 8, 16), (2, 700, 32, 16)])
def test_merges_match_the_jax_package(seed, n, K, bins):
    counts, means, m2s, hists, qvals = random_sketches(seed, n, K, bins)

    c, mean, m2 = ops.merge_moments(counts, means, m2s, device="cpu")
    rc, rmean, rm2 = ref_ops.merge_moments(counts, means, m2s)
    assert c == rc
    assert mean == pytest.approx(rmean, rel=1e-6)
    assert m2 == pytest.approx(rm2, rel=1e-6)

    h = ops.merge_histograms(hists, device="cpu")
    assert h.dtype == np.int64 and np.array_equal(h, ref_ops.merge_histograms(hists))

    v, w = ops.merge_quantile_sketches(qvals, counts, device="cpu")
    rv, rw = ref_ops.merge_quantile_sketches(qvals, counts)
    assert np.array_equal(v.view(np.int32), np.asarray(rv).view(np.int32))
    assert w.dtype == np.float64 and np.array_equal(w, rw)


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_moments_matches_sequential_reference(seed):
    counts, means, m2s, _, _ = random_sketches(seed, 300, 4, 4)
    c, mean, m2 = ops.merge_moments(counts, means, m2s, device="cpu")
    cr, meanr, m2r = merge_moments_reference(zip(counts, means, m2s))
    assert c == cr
    assert mean == pytest.approx(meanr, rel=1e-5)
    assert m2 == pytest.approx(m2r, rel=1e-5)


def test_merges_of_an_empty_fleet():
    z = np.zeros(4, np.float32)
    assert ops.merge_moments(z, z, z, device="cpu") == (0.0, 0.0, 0.0)
    v, w = ops.merge_quantile_sketches(np.full((4, 2), np.nan, np.float32), z, device="cpu")
    assert np.isnan(v).all() and not w.any()


def test_merges_on_cuda_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.merge_histograms(np.zeros((2, 3), np.int64))
