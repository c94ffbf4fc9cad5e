"""The apply (``apply_rows``: decompress scatter-add + transmit record) on
planted payloads against the JAX package's ``dgc_apply_rows_reference`` /
``payload_apply_bits_reference``, and the launch plan of its Hopper
kernel (``apply_plan``), whose routes and scratch the CPU cannot run.

Tolerance: the record bitwise; ``acc`` bitwise where one entry reaches a
coordinate, and within rtol 1e-6 where several do, because the
reference's scatter leaves the order of duplicate updates to XLA while
the port adds them in payload order (on the CPU XLA happens to add them
in payload order too, so these cases are in fact bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.ops import kernels as jk
from dgc_tpu_torch.ops import kernels as tk

CHUNK = 4096


def _reference(v, i, f, total, divisor):
    if divisor is None:
        a, b = jk.payload_apply_bits_reference(
            jnp.asarray(v), jnp.asarray(i), jnp.asarray(f), total)
    else:
        a, b = jk.dgc_apply_rows_reference(
            jnp.asarray(v), jnp.asarray(i), jnp.asarray(f), total,
            divisor=divisor)
    return np.asarray(a), np.asarray(b)


def _port(v, i, f, total, divisor):
    a, b = tk.apply_rows(torch.from_numpy(v), torch.from_numpy(i),
                         torch.from_numpy(f), total, divisor)
    return a.numpy(), b.numpy()


def _assert_matches(v, i, f, total, divisor):
    ra, rb = _reference(v, i, f, total, divisor)
    pa, pb = _port(v, i, f, total, divisor)
    np.testing.assert_array_equal(pb, rb)
    hits = np.bincount(i[v != 0], minlength=total)[:total]
    one = hits <= 1
    np.testing.assert_array_equal(pa[one].view(np.int32),
                                  ra[one].view(np.int32))
    np.testing.assert_allclose(pa[~one], ra[~one], rtol=1e-6, atol=0)
    return pa, pb


def _flags_once(rng, i, count):
    """Flags on ``count`` entries with distinct indices (the engine flags
    one worker's unique coordinates)."""
    f = np.zeros(i.shape, bool)
    _, first = np.unique(i, return_index=True)
    f[rng.choice(first, min(count, first.size), replace=False)] = True
    return f


def _case(name, rng):
    """(values, indices, flags, total) of one planted payload."""
    if name == "boundary":
        total = 4 * CHUNK
        i = np.array([4094, 4095, 4096, 4097, 4095, 4096, 8191, 8192,
                      2 * CHUNK - 1, 3 * CHUNK], np.int32)
        f = np.array([1, 1, 1, 1, 0, 0, 1, 1, 0, 1], bool)
        return rng.randn(i.size).astype(np.float32), i, f, total
    if name == "partial_last_chunk":
        total = 3 * CHUNK + 2048
        i = np.concatenate([rng.randint(0, total, 3000),
                            np.arange(total - 256, total)]).astype(np.int32)
        f = np.zeros(i.size, bool)
        f[-256:] = True
        return rng.randn(i.size).astype(np.float32), i, f, total
    if name == "hot_chunk":
        # more entries in chunk 1 than a block's 227 KB of shared memory
        # holds at 8 bytes an entry, one coordinate 500 times
        total = 4 * CHUNK
        i = np.concatenate([CHUNK + rng.randint(0, CHUNK, 30_000),
                            np.full(500, CHUNK + 904),
                            rng.randint(0, total, 500)]).astype(np.int32)
        i = i[rng.permutation(i.size)]
        return (rng.randn(i.size).astype(np.float32), i,
                _flags_once(rng, i, 2000), total)
    if name == "w8_all_workers":
        total, world = 2 * CHUNK + 128, 8
        i = np.stack([rng.permutation(total) for _ in range(world)])
        f = np.arange(world)[:, None] == 5
        return (rng.randn(world * total).astype(np.float32),
                i.reshape(-1).astype(np.int32),
                np.broadcast_to(f, i.shape).reshape(-1).copy(), total)
    if name == "zero_flagged":
        total = 2 * CHUNK
        i = rng.permutation(total)[:600].astype(np.int32)
        v = rng.randn(600).astype(np.float32)
        v[:200] = 0.0
        f = np.zeros(600, bool)
        f[100:400] = True
        return v, i, f, total
    if name == "minus_zero":
        total = 2 * CHUNK
        i = np.concatenate([rng.permutation(total)[:300],
                            rng.randint(0, total, 300)]).astype(np.int32)
        v = rng.randn(600).astype(np.float32)
        v[::3] = -0.0
        return v, i, _flags_once(rng, i, 150), total
    if name == "empty":
        return (np.zeros(0, np.float32), np.zeros(0, np.int32),
                np.zeros(0, bool), 3 * CHUNK + 128)
    raise KeyError(name)


CASES = ["boundary", "partial_last_chunk", "hot_chunk", "w8_all_workers",
         "zero_flagged", "minus_zero", "empty"]


@pytest.mark.parametrize("divisor", [None, 4.0, 3.0])
@pytest.mark.parametrize("case", CASES)
def test_apply_matches_reference(case, divisor):
    rng = np.random.RandomState(CASES.index(case))
    v, i, f, total = _case(case, rng)
    if case == "w8_all_workers" and divisor == 4.0:
        divisor = 8.0
    acc, bits = _assert_matches(v, i, f, total, divisor)
    assert acc.shape == (total,)
    assert bits.shape == (tk.num_sent_words(total),)


def test_zero_flagged_entries_set_bits_and_add_nothing():
    rng = np.random.RandomState(21)
    v, i, f, total = _case("zero_flagged", rng)
    acc, bits = _port(v, i, f, total, 4.0)
    keep = tk.keep_from_bits(torch.from_numpy(bits), total).numpy()
    zero_sent, zero_kept = i[100:200], i[:100]     # value 0 (unique i)
    assert (acc[zero_sent] == 0).all() and (acc[zero_kept] == 0).all()
    assert not keep[zero_sent].any()               # flagged: sent
    assert keep[zero_kept].all()
    assert not keep[i[f]].any() and keep.sum() == total - f.sum()


def test_minus_zero_adds_nothing():
    """A selected -0.0 leaves +0.0 where it is alone, as the reference's
    zeros-operand scatter-add does (+0.0 + -0.0 = +0.0)."""
    total = CHUNK
    v = np.array([-0.0, -0.0, 1.5, -0.0], np.float32)
    i = np.array([7, 9, 9, 11], np.int32)
    f = np.array([True, False, True, False])
    acc, _ = _assert_matches(v, i, f, total, 4.0)
    assert acc[[7, 11]].view(np.int32).tolist() == [0, 0]
    assert acc[9] == np.float32(1.5) / np.float32(4.0)


@pytest.mark.parametrize("divisor", [None, 2.0])
def test_apply_out_of_range_indices_change_nothing(divisor):
    """Indices of -1, ``total`` and above change neither the sums nor the
    record (flagged or not): the result is the reference's on the payload
    without them. (The reference's own scatter would wrap -1 to the last
    coordinate; the engine routes such indices to its sentinel first.)"""
    total = 2 * CHUNK
    rng = np.random.RandomState(8)
    i = rng.randint(0, total, 400).astype(np.int32)
    v = rng.randn(400).astype(np.float32)
    f = _flags_once(rng, i, 100)
    bad = rng.choice(400, 40, replace=False)
    i_bad = i.copy()
    i_bad[bad] = np.array([-1, total, total + 4096, -4096] * 10, np.int32)
    f_bad = f.copy()
    f_bad[bad[:20]] = True
    keep = np.setdiff1d(np.arange(400), bad)
    got = _port(v, i_bad, f_bad, total, divisor)
    want = _assert_matches(v[keep], i[keep], f[keep], total, divisor)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_divisor_is_an_ieee_divide():
    """``v / divisor`` per entry, as the reference divides (not a multiply
    by the reciprocal, which differs at divisor 3)."""
    v = np.array([1.0, 2.0, 5.0, 7.0, 1e-3], np.float32)
    i = np.arange(5, dtype=np.int32)
    acc, _ = _port(v, i, np.zeros(5, bool), CHUNK, 3.0)
    np.testing.assert_array_equal(acc[:5], v / np.float32(3.0))


# ------------------------------------------------------------------ #
# the launch plan                                                    #
# ------------------------------------------------------------------ #

R20_T, R50_T = 370_688, 27_068_416


@pytest.mark.parametrize("n,total,route,grid,cap", [
    (1_132, R20_T, "scan", 91, 1_132),            # ResNet-20, epoch 5
    (342_704, R20_T, "list", 91, 6_144),          # ResNet-20, epoch 0
    (102_332, R50_T, "list", 6_609, 512),         # ResNet-50, epoch 5
    (32_321_208, R50_T, "list", 6_609, 7_680),    # ResNet-50, epoch 0
])
def test_apply_plan_at_the_chip_shapes(n, total, route, grid, cap):
    plan = tk.apply_plan(n, total)
    assert (plan.route, plan.grid, plan.cap) == (route, grid, cap)
    assert plan.chunk == tk.APPLY_CHUNK == 4096
    assert plan.grid * 128 == tk.num_sent_words(total)
    fixed = 4 * (4096 + 128 + 128 + 64) + 256 * (8 + 8 + 4)
    assert plan.smem_bytes == fixed + (8 if route == "list" else 20) * plan.cap
    assert plan.smem_bytes <= 227 * 1024
    if route == "list":
        # two list-route chunk blocks fit one SM's 228 KB
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
        a16 = lambda x: -(-x // 16) * 16
        slots = grid * plan.cap                   # a segment per chunk
        assert plan.scratch_bytes == (a16(4 * (grid + 2)) + a16(8 * slots)
                                      + a16(4 * slots) + a16(8 * n)
                                      + 3 * a16(4 * n))
        assert plan.route_grid == min(-(-n // 2048), 132 * 4)
    else:
        assert plan.scratch_bytes == 0 and plan.route_grid == 0


def test_apply_plan_edges():
    # the crossover: the scan route up to APPLY_SCAN_MAX_N entries and
    # APPLY_SCAN_MAX_WORK entries x chunks
    small_t = 8 * CHUNK
    scan = tk.apply_plan(tk.APPLY_SCAN_MAX_N, small_t)
    assert scan.route == "scan" and scan.smem_bytes <= 227 * 1024
    assert tk.apply_plan(tk.APPLY_SCAN_MAX_N + 1, small_t).route == "list"
    wide = tk.APPLY_SCAN_MAX_WORK // 1000 * CHUNK + CHUNK
    assert tk.apply_plan(1000, wide).route == "list"
    # n = 0: the scan route still writes every chunk (zeros)
    p = tk.apply_plan(0, 3 * CHUNK + 128)
    assert (p.route, p.grid, p.cap) == ("scan", 4, 1)
    # a partial last chunk is one more block
    assert tk.apply_plan(10, 4 * CHUNK + 2048).grid == 5
    assert tk.apply_plan(10, 0).grid == 0
    # the list route's capacity stays within [512, 11264]
    assert tk.apply_plan(5_000, R20_T, "list").cap == 512
    assert tk.apply_plan(10**9, 8 * CHUNK, "list").cap == 11_264
    # more chunks than the scatter's shared histogram takes (12,288): the
    # list route, its scatter on the per-warp path
    wide = tk.apply_plan(3000, 12_289 * CHUNK)
    assert (wide.route, wide.grid, wide.cap) == ("list", 12_289, 512)
    # forced routes, and an unknown one
    assert tk.apply_plan(50_000, small_t, "scan").cap == 50_000
    assert tk.apply_plan(10, small_t, "list").route == "list"
    with pytest.raises(ValueError):
        tk.apply_plan(10, small_t, "sort")


def test_apply_rows_checks_its_operands():
    v = torch.ones(4)
    i = torch.arange(4, dtype=torch.int32)
    f = torch.ones(4, dtype=torch.bool)
    # int32 and int64 indices are taken (int64 for layouts of 2**31
    # slots or more); any other index dtype is refused
    with pytest.raises(ValueError):
        tk.apply_rows(v, i.to(torch.int16), f, 128)
    with pytest.raises(ValueError):
        tk.apply_rows(v, i.float(), f, 128)
    with pytest.raises(ValueError):
        tk.apply_rows(v, i, f[:3], 128)
    with pytest.raises(ValueError):
        tk.apply_rows(v, i, f, 100)               # not lane-aligned
