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


def _wide_case(G, n_pairs, N=2048, seed=11):
    """N % 2048 == 0 (the JAX kernel's precondition), 7-ish pairs mixing
    int32 and int64-range values, ids -1 and G dropped, and pairs 0 and 4
    equal (as sum(x) and avg(x) make them)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(-1, G + 1, N).astype(np.int32)
    mask = rng.random(N) < 0.85
    pairs = []
    for k in range(n_pairs):
        a = rng.integers(-(2**31), 2**31 - 1, N).astype(np.int32)
        b = None if k % 3 == 0 else rng.integers(-50_000, 50_000, N).astype(np.int32)
        pairs.append((a, b))
    if n_pairs > 4:
        pairs[4] = pairs[0]
    return seg, mask, pairs, G


@pytest.mark.parametrize("G", [8, 9])
def test_plain_equals_pallas_interpret_at_register_cap(G):
    """G = 8 is the register route's cap for up to 8 pairs, G = 9 the first
    G past it (the shared route on the card)."""
    args = _wide_case(G, 7)
    for g, w in zip(_port(*args), _jax(*args)):
        assert g.shape == w.shape and np.array_equal(g, w)


def _plan(G, n_pairs, n=1 << 23, sm=132, per_sm=lambda *a: 2):
    return DA.launch_plan(G, n_pairs, n, sm, per_sm)


SHARED_LAST_G = DA.SHARED_BYTES_MAX // (DA.SHARED_MIN_WARPS * 2 * 8)  # 1 pair


@pytest.mark.parametrize("G,n_pairs,route,g_max", [
    (1, 0, "registers", 1), (1, 1, "registers", 1), (1, 7, "registers", 1),
    (1, 16, "registers", 1), (6, 0, "registers", 8), (6, 7, "registers", 8),
    (8, 8, "registers", 8), (9, 7, "shared", None), (8, 9, "shared", None),
    (6, 16, "shared", None), (SHARED_LAST_G, 1, "shared", None),
    (SHARED_LAST_G + 1, 1, "global", None), (16384, 0, "global", None),
    (16384, 7, "global", None), (16384, 16, "global", None)])
def test_launch_plan_routes_at_their_boundaries(G, n_pairs, route, g_max):
    plan = _plan(G, n_pairs)
    assert plan.route == route == DA.kernel_route(G, n_pairs)
    if route == "registers":
        assert DA.REGISTER_SHAPES[plan.variant] == (g_max, n_pairs)
        assert plan.smem_bytes == 0 and plan.threads == DA.THREADS
    else:
        assert plan.variant == -1
    if route == "shared":
        table = G * (n_pairs + 1) * 8
        warps = plan.threads // 32
        assert DA.SHARED_MIN_WARPS <= warps <= 8
        assert plan.smem_bytes == warps * table <= DA.SHARED_BYTES_MAX
    if route == "global":
        assert plan.smem_bytes == 0


def test_launch_plan_grid_is_one_wave_or_what_n_needs():
    seen = []
    plan = _plan(6, 5, per_sm=lambda *a: seen.append(a) or 3)
    assert plan.grid == 132 * 3 and seen == [("registers", 22, 256, 0)]
    assert _plan(6, 5, n=3000).grid == 3  # 750 steps of 4 rows, 256 a block
    assert _plan(6, 5, n=0).grid == 1 and _plan(6, 5, n=1).grid == 1
    with pytest.raises(RuntimeError, match="cannot run"):
        _plan(1000, 2, per_sm=lambda *a: 0)
    with pytest.raises(ValueError):
        _plan(6, DA.MAX_PAIRS + 1)
    with pytest.raises(ValueError):
        _plan(0, 1)


def test_register_shapes_cover_every_g1_and_small_table():
    assert set(DA.REGISTER_SHAPES) == ({(1, p) for p in range(17)}
                                       | {(8, p) for p in range(9)})
    assert len(set(DA.REGISTER_SHAPES)) == len(DA.REGISTER_SHAPES)


@pytest.mark.parametrize("n,seg_off,mask_off,factors,want", [
    (1 << 20, 0, 0, [(0, 8), (0, 4)], (0, 1 << 20)),
    (1 << 20, 4, 1, [(8, 8), (4, 4)], (3, (1 << 20) - 1)),  # every column t[1:]
    (1003, 0, 0, [(0, 8)], (0, 1000)),                      # ragged tail
    (5, 0, 0, [], (0, 4)),
    (3, 0, 0, [], (0, 0)),
    (2, 4, 1, [], (2, 2)),                                  # head past n
    (1 << 20, 0, 1, [(0, 8)], (1 << 20, 1 << 20)),          # only the mask at 1
    (1 << 20, 4, 1, [(0, 8)], (1 << 20, 1 << 20)),          # an int64 not at 1
    (0, 0, 0, [], (0, 0)),
])
def test_vector_span(n, seg_off, mask_off, factors, want):
    base = 1 << 20  # 512-byte-aligned like the caching allocator's blocks
    head, tail = DA.vector_span(n, base + seg_off, base + mask_off,
                                [(base + o, s) for o, s in factors])
    assert (head, tail) == want
    assert 0 <= head <= tail <= n and (tail - head) % DA.RUN == 0


def test_distinct_pairs_merge_repeats_into_output_columns():
    t = torch.arange
    qty, price, disc = t(8), t(8) + 1, t(8, dtype=torch.int32)
    pairs = [(qty, None), (price, None), (price, disc), (qty, None),
             (price, None), (disc, None), (price, qty)]
    unique, cols = DA.distinct_pairs(pairs)
    assert [(a is qty, a is price, b is disc) for a, b in unique][:3] == [
        (True, False, False), (False, True, False), (False, True, True)]
    assert len(unique) == 5
    assert cols == [0b1001, 0b10010, 0b100, 0b100000, 0b1000000]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    dev = torch.device("cuda")
    cases = [_pallas_case(s) for s in range(3)] + [_carry_case()] + [
        _extra_case(k) for k in ("ragged", "one_group", "count_only", "wrap")]
    cases += [_wide_case(G, p) for G, p in ((1, 0), (1, 16), (8, 8), (9, 7),
                                           (8, 9), (SHARED_LAST_G, 1),
                                           (SHARED_LAST_G + 1, 1), (16384, 7))]
    cases += [_wide_case(6, 5, N=n) for n in (1, 5, 3000)]
    routes = set()
    for seg, mask, pairs, G in cases:
        t = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa: E731
        args = (t(seg), t(mask), [(t(a), t(b)) for a, b in pairs], G)
        views = (args[0][1:], args[1][1:],
                 [(a[1:], None if b is None else b[1:]) for a, b in args[2]], G)
        mixed = (args[0][:-1], args[1][1:],
                 [(a[:-1], None if b is None else b[:-1]) for a, b in args[2]], G)
        for call in (args, views, mixed):
            before = DA.launches
            got = DA.dense_groupby_sums(*call)
            assert DA.launches == before + 1
            want = DA.dense_groupby_sums_plain(*call)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        routes.add(DA.kernel_route(G, len(DA.distinct_pairs(args[2])[0])))
    assert routes == set(DA.ROUTES)
