"""The port's ops/kernels.py subset against the JAX package's ops/kernels.py:
stable multi-key sort, row sort, compaction and masked segment reductions,
on the same numpy inputs, compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.ops import kernels as JK
from datafusion_tpu_torch.ops import kernels as TK


def _sort_keys(seed: int, with_bounds: bool):
    """Three keys with many ties: a nullable int32 (DESC, nulls first), a
    bool (ASC) and an int64 (DESC, nulls last) -- plus a float key when no
    bounds are given (floats never pack)."""
    rng = np.random.default_rng(seed)
    n = 1000
    sel = rng.random(n) < 0.8
    k1 = rng.integers(-3, 4, n).astype(np.int32)
    v1 = rng.random(n) < 0.85
    k1 = np.where(v1, k1, 0).astype(np.int32)
    k2 = rng.random(n) < 0.5
    k3 = rng.integers(0, 5, n).astype(np.int64)
    v3 = rng.random(n) < 0.9
    k3 = np.where(v3, k3, 0)
    keys = [(k1, v1, True, True, (-3, 3)), (k2, None, False, False, (0, 1)),
            (k3, v3, True, False, (0, 4))]
    if not with_bounds:
        keys = [k[:4] for k in keys]
        keys.append((np.round(rng.random(n) * 4) / 4, None, False, False))
    return keys, sel


def _as(keys, conv):
    return [tuple(conv(x) if isinstance(x, np.ndarray) else x for x in k)
            for k in keys]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("with_bounds", [True, False], ids=["packed", "multipass"])
def test_sort_permutation_matches(seed, with_bounds):
    keys, sel = _sort_keys(seed, with_bounds)
    want = np.asarray(JK.sort_permutation(_as(keys, jnp.asarray), jnp.asarray(sel)))
    got = TK.sort_permutation(_as(keys, torch.from_numpy), torch.from_numpy(sel))
    assert np.array_equal(got.numpy(), want)
    # dead rows sink to the end; ties keep input order (stability)
    assert not sel[want[sel.sum():]].any()


def test_sort_rows_matches():
    keys, sel = _sort_keys(3, with_bounds=True)
    rng = np.random.default_rng(3)
    payload = [rng.integers(0, 100, len(sel)).astype(np.int64),
               rng.random(len(sel)), rng.random(len(sel)) < 0.5]
    wp, ws = JK.sort_rows(_as(keys, jnp.asarray), [jnp.asarray(p) for p in payload],
                          jnp.asarray(sel))
    gp, gs = TK.sort_rows(_as(keys, torch.from_numpy),
                          [torch.from_numpy(p) for p in payload], torch.from_numpy(sel))
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    for g, w in zip(gp, wp):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
def test_compaction_indices_matches(density):
    """The blocked JAX compaction (n >= 4 blocks) and the port agree on the
    contract: the first `cap` live indices ascending, and the live count."""
    rng = np.random.default_rng(int(density * 100))
    n = 8192
    sel = rng.random(n) < density
    for cap in (256, 4096, n):
        widx, wtot = JK.compaction_indices(jnp.asarray(sel), cap)
        gidx, gtot = TK.compaction_indices(torch.from_numpy(sel), cap)
        assert int(gtot) == int(wtot) == int(sel.sum())
        k = min(int(wtot), cap)
        assert np.array_equal(gidx.numpy()[:k], np.asarray(widx)[:k])
        assert np.array_equal(gidx.numpy()[:k], np.nonzero(sel)[0][:k])


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
@pytest.mark.parametrize("num_segments", [1, 7])
def test_segment_sum_and_count_match(dtype, num_segments):
    """Out-of-range ids (negative, == and > num_segments) are dropped, as
    jax.ops.segment_sum drops them. Float values are small integers, so every
    summation order gives the same bits."""
    rng = np.random.default_rng(num_segments)
    n = 5000
    seg = rng.integers(-2, num_segments + 3, n).astype(np.int32)
    if num_segments == 1:
        seg = np.zeros(n, np.int32)  # the global path ignores ids
    mask = rng.random(n) < 0.7
    vals = rng.integers(-1000, 1000, n).astype(dtype)
    want = np.asarray(JK.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                     jnp.asarray(mask), num_segments))
    got = TK.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                         torch.from_numpy(mask), num_segments).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    wc = np.asarray(JK.segment_count(jnp.asarray(seg), jnp.asarray(mask), num_segments))
    gc = TK.segment_count(torch.from_numpy(seg), torch.from_numpy(mask),
                          num_segments).numpy()
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
