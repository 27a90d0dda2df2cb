"""The port's dense_groupby_sums (datafusion_tpu_torch/ops/dense_agg.py)
against the JAX package's Pallas kernel run in interpret mode, bit for bit.
On the CPU the wrapper runs its plain version; the CUDA kernel itself is held
against the plain version in the `cuda`-marked test, on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.ops import pallas_agg as PA
from datafusion_tpu_torch.ops import dense_agg as DA


def _port(seg, mask, pairs, G):
    t = torch.from_numpy
    out = DA.dense_groupby_sums(
        t(seg), t(mask), [(t(a), None if b is None else t(b)) for a, b in pairs], G)
    return out[0].numpy(), out[1].numpy()


def _jax(seg, mask, pairs, G):
    j = jnp.asarray
    sums, cnt = PA.dense_groupby_sums(
        j(seg), j(mask), [(j(a), None if b is None else j(b)) for a, b in pairs],
        G, interpret=True)
    return np.asarray(sums), np.asarray(cnt)


def _numpy(seg, mask, pairs, G):
    live = mask & (seg >= 0) & (seg < G)
    sums = np.zeros((G, max(len(pairs), 1)), dtype=np.int64)
    for k, (a, b) in enumerate(pairs):
        prod = a[live].astype(np.int64) * (1 if b is None else b[live].astype(np.int64))
        np.add.at(sums[:, k], seg[live], prod)
    counts = np.zeros(G, dtype=np.int64)
    np.add.at(counts, seg[live], 1)
    return sums, counts


def _pallas_case(seed):
    """tests/test_pallas_agg.py's random case: id G is dropped."""
    rng = np.random.default_rng(seed)
    N, G = 4096, 6
    seg = rng.integers(0, G + 1, N).astype(np.int32)
    mask = rng.random(N) < 0.9
    a1 = rng.integers(-10_000_000, 10_000_000, N).astype(np.int32)
    b1 = rng.integers(0, 10_000, N).astype(np.int32)
    a2 = rng.integers(0, 2**31 - 1, N).astype(np.int32)
    return seg, mask, [(a1, b1), (a2, None)], G


def _carry_case():
    N = 2048
    return (np.zeros(N, np.int32), np.ones(N, bool),
            [(np.full(N, 2**30, np.int32), np.full(N, 1000, np.int32))], 2)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "carry"])
def test_plain_equals_pallas_interpret(case):
    args = _carry_case() if case == "carry" else _pallas_case(int(case[-1]))
    got, want = _port(*args), _jax(*args)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape == w.shape
        assert np.array_equal(g, w)
    if case == "carry":
        assert int(got[0][0, 0]) == 2048 * (2**30) * 1000


def _extra_case(kind):
    rng = np.random.default_rng(7)
    if kind == "ragged":  # N % 2048 != 0: the JAX kernel refuses it
        N, G = 3000, 5
        seg = rng.integers(-1, G + 2, N).astype(np.int32)  # both sides out of range
        return seg, rng.random(N) < 0.8, [
            (rng.integers(-(2**31), 2**31 - 1, N).astype(np.int32),
             rng.integers(-(2**40), 2**40, N).astype(np.int64)),
            (rng.integers(0, 100, N).astype(np.int64), None)], G
    if kind == "one_group":
        N = 2048
        seg = rng.integers(0, 2, N).astype(np.int32)
        return seg, rng.random(N) < 0.5, [
            (rng.integers(0, 10_500_000, N).astype(np.int64),
             rng.integers(0, 11, N).astype(np.int64))], 1
    if kind == "count_only":
        N, G = 2048, 6
        return rng.integers(0, G + 1, N).astype(np.int32), rng.random(N) < 0.7, [], G
    if kind == "wrap":  # products and sums that wrap mod 2^64
        N = 100
        big = np.full(N, 2**62 + 12345, np.int64)
        return np.zeros(N, np.int32), np.ones(N, bool), [(big, big), (big, None)], 1
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["ragged", "one_group", "count_only", "wrap"])
def test_plain_equals_numpy(kind):
    args = _extra_case(kind)
    with np.errstate(over="ignore"):
        want = _numpy(*args)
    got = _port(*args)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_one_group_and_count_only_equal_pallas_interpret():
    """G = 1 and the count-only call at a size the JAX kernel takes."""
    for kind in ("one_group", "count_only"):
        args = _extra_case(kind)
        for g, w in zip(_port(*args), _jax(*args)):
            assert np.array_equal(g, w)


def test_cpu_tensor_never_counts_a_launch():
    DA.reset_launches()
    _port(*_carry_case())
    assert DA.launches == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    dev = torch.device("cuda")
    cases = [_pallas_case(s) for s in range(3)] + [_carry_case()] + [
        _extra_case(k) for k in ("ragged", "one_group", "count_only", "wrap")]
    for seg, mask, pairs, G in cases:
        t = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa: E731
        args = (t(seg), t(mask), [(t(a), t(b)) for a, b in pairs], G)
        before = DA.launches
        got = DA.dense_groupby_sums(*args)
        assert DA.launches == before + 1
        want = DA.dense_groupby_sums_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
