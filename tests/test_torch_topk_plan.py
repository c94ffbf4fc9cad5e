"""The top-k kernel's launch planner (``kernels.topk_plan``) and its plain
version at the cases that cross the planner's routes.

The planner is pure arithmetic, checked at every call shape the DGC paths
give the kernel (ResNet-20 across the wm5 warm-up, ResNet-50 at the
epoch-0 and epoch-5 ratios: 44 shapes), and at k = 1, k = cols and
k = 16,384: each shape gets a route, its shared memory fits one block's
227 KB, and a cluster has at most 8 blocks and divides the grid.

``topk_rows_plain`` (what the wrapper runs on CPU tensors and what the
kernel is held bitwise against on the card) is held against the JAX
package's ``topk_rows``, run as test_torch_kernels.py runs it: the Pallas
kernel in interpret mode for k <= 128, ``lax.top_k`` (to which the JAX
function delegates) above. Rows: ties at the k-th value planted at columns
cols/8*j - 1, cols/8*j and cols/8*j + 1 (the boundaries of the cluster
route's slices), an all-equal row, an all-zero row with -0.0 at even
columns, |x| with a -1 tail and -inf entries (the engine's sentinels), and
signed values with -0.0 planted. Columns and values are bitwise, with two
stated exceptions, both at signed zeros, which the engine's importance
(|x| or a sentinel) never holds: the port reads each value back from the
row, so a selected -0.0 keeps its sign where the Pallas kernel writes the
row maximum (+0.0); and ``lax.top_k`` orders +0.0 before -0.0, where the
port and the Pallas kernel tie them and take the lower column first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.ops import kernels as jk
from dgc_tpu_torch.ops import kernels as tk

#: (rows, cols, k) of every top-k kernel call one worker's step makes on
#: the DGC paths: ResNet-20 at epochs 0-5, ResNet-50 at epochs 0 and 5
PATH_SHAPES = [
    (6, 36864, 11658), (6, 384, 121), (16, 9216, 2915), (16, 95, 31),
    (6, 36864, 3687), (6, 384, 38), (16, 9216, 922), (16, 95, 10),
    (6, 36864, 1166), (6, 384, 13), (16, 9216, 292), (16, 512, 17),
    (6, 36864, 369), (6, 384, 4), (16, 9216, 93), (16, 640, 7),
    (6, 36864, 117), (6, 768, 3), (16, 9216, 30), (16, 4608, 15),
    (6, 36864, 37), (6, 2176, 3), (16, 9216, 10),
    (3, 24448, 7692), (2, 21632, 6837), (5, 10880, 3419), (8, 6144, 1923),
    (17, 2816, 855), (11, 768, 214), (8, 16384, 5182), (8, 256, 54),
    (3, 18432, 2360), (3, 24448, 25), (2, 16384, 2098), (2, 21632, 22),
    (5, 8192, 1049), (5, 10880, 11), (8, 5120, 590), (8, 6144, 7),
    (17, 2048, 263), (17, 2816, 3), (11, 512, 66), (11, 3712, 4),
    (8, 16384, 17)]

SMEM_MAX = 227 * 1024


def _check_plan(R, cols, k, plan):
    assert plan.route in tk.TOPK_ROUTES
    assert plan.smem_bytes <= SMEM_MAX and plan.smem_bytes % 16 == 0
    assert 1 <= plan.cluster <= 8 and plan.grid % plan.cluster == 0
    assert plan.grid == R * plan.cluster
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.padded >= k and plan.padded & (plan.padded - 1) == 0
    if plan.route == "sort":                  # every column, sorted
        assert cols <= plan.padded < 2 * cols and not plan.radix
    else:
        assert plan.radix == (plan.padded >= tk.TOPK_RADIX_MIN_WORDS)
    if plan.route == "cluster":
        assert plan.cluster >= 2
        assert plan.slice % 4 == 0 and plan.slice * plan.cluster >= cols
        assert (plan.cluster - 1) * plan.slice < cols  # no empty block
    else:
        assert plan.cluster == 1 and plan.slice == cols
    if plan.staged:
        assert plan.stage_words % 4 == 0
        assert plan.stage_words >= plan.slice + 6   # the aligned span
    else:
        assert plan.stage_words == 0


@pytest.mark.parametrize("R,cols,k", PATH_SHAPES)
def test_topk_plan_at_path_shapes(R, cols, k):
    plan = tk.topk_plan(R, cols, k)
    _check_plan(R, cols, k, plan)
    assert plan.staged                     # every path row fits on chip


@pytest.mark.parametrize("R,cols", sorted({(r, c) for r, c, _ in
                                           PATH_SHAPES}))
def test_topk_plan_k_extremes(R, cols):
    ks = {1, min(cols, tk.TOPK_MAX_K)} | (
        {tk.TOPK_MAX_K} if cols >= tk.TOPK_MAX_K else set())
    for k in ks:
        _check_plan(R, cols, k, tk.topk_plan(R, cols, k))


@pytest.mark.parametrize("R,cols,k,route", [
    (16, 95, 10, "sort"), (6, 384, 121, "sort"), (8, 256, 54, "sort"),
    (11, 512, 66, "sort"), (16, 512, 17, "sort"), (11, 768, 214, "block"),
    (17, 2816, 855, "block"), (16, 4608, 15, "block"),
    (8, 6144, 1923, "block"),
    (16, 9216, 2915, "cluster"), (5, 10880, 11, "cluster"),
    (6, 36864, 11658, "cluster"), (3, 24448, 25, "cluster"),
    (8, 16384, 17, "cluster")])
def test_topk_plan_routes(R, cols, k, route):
    """The route each family of path shapes takes: narrow rows sorted
    whole, wider ones selected by a block each, or over a cluster where
    the rows alone would leave most SMs idle."""
    assert tk.topk_plan(R, cols, k).route == route


def test_topk_plan_wide_and_forced():
    # a row whose slice and sort buffer fit no block's shared memory, even
    # over 8 blocks, is read from global memory
    plan = tk.topk_plan(1, 300001, 16384)
    _check_plan(1, 300001, 16384, plan)
    assert plan.route == "cluster" and not plan.staged
    # many wide rows: the cluster only where the row does not fit a block
    assert tk.topk_plan(200, 20000, 100).route == "block"
    plan = tk.topk_plan(200, 40000, 16384)
    _check_plan(200, 40000, 16384, plan)
    assert plan.route == "cluster" and plan.staged
    # the radix sort of the survivors needs its counters beside the row
    plan = tk.topk_plan(3, 36864, 16384, "block")
    _check_plan(3, 36864, 16384, plan)
    assert plan.radix and not plan.staged
    for route in tk.TOPK_ROUTES:
        for R, cols, k in ((5, 95, 10), (5, 4099, 1000), (5, 36867, 16384)):
            if route == "sort" and cols > tk.TOPK_MAX_K:
                continue
            plan = tk.topk_plan(R, cols, k, route)
            assert plan.route == route
            _check_plan(R, cols, k, plan)
    with pytest.raises(ValueError):
        tk.topk_plan(2, 100, 101)
    with pytest.raises(ValueError):
        tk.topk_plan(2, 20000, tk.TOPK_MAX_K + 1)
    with pytest.raises(ValueError):
        tk.topk_plan(2, 100, 5, "grid")


def _planted_rows(rng, cols, k):
    x = rng.randn(5, cols).astype(np.float32)
    kth = np.sort(x[0])[::-1][k - 1]
    ties = [c for j in range(9) for c in (cols // 8 * j - 1, cols // 8 * j,
                                          cols // 8 * j + 1) if 0 <= c < cols]
    x[0, ties] = kth
    x[1] = 0.5
    x[2] = 0.0
    x[2, ::2] = -0.0
    x[3] = np.abs(x[3])
    x[3, cols // 2:] = -1.0
    x[3, ::7] = -np.inf
    x[4, ::5] = -0.0
    return x


@pytest.mark.parametrize("cols,k", [(95, 1), (95, 37), (95, 95),
                                    (4099, 1), (4099, 128), (4099, 300),
                                    (16387, 37), (16387, 2000),
                                    (36867, 128), (36867, 11658)])
def test_topk_rows_plain_matches_jax_at_route_boundaries(cols, k):
    x = _planted_rows(np.random.RandomState(cols + k), cols, k)
    jv, ji = (np.asarray(a) for a in jk.topk_rows(jnp.asarray(x), k))
    tv, ti = tk.topk_rows(torch.from_numpy(x), k)
    tv, ti = tv.numpy(), ti.numpy()
    # values are the row's own, read back at the returned columns
    np.testing.assert_array_equal(
        tv.view(np.int32), np.take_along_axis(x, ti.astype(np.int64),
                                              1).view(np.int32))
    neg_zero = tv.view(np.int32) == np.float32(-0.0).view(np.int32)
    if k <= 128:                           # the Pallas kernel
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv[~neg_zero].view(np.int32),
                                      jv[~neg_zero].view(np.int32))
        np.testing.assert_array_equal(jv[neg_zero], 0.0)    # +0.0 there
    else:                                  # lax.top_k: +0.0 before -0.0
        rows = [0, 1, 3, 4]                # no +0.0 / -0.0 ties
        np.testing.assert_array_equal(ti[rows], ji[rows])
        np.testing.assert_array_equal(tv[rows].view(np.int32),
                                      jv[rows].view(np.int32))
        np.testing.assert_array_equal(tv[2], jv[2])          # as numbers


def _c_params(src, fn):
    """The ctypes type of each parameter of ``extern "C" int fn(...)`` in
    dgc_tpu_torch/csrc/``src``."""
    import ctypes
    import re
    from dgc_tpu_torch.ops import build
    text = (build.CSRC / src).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, fn
    out = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        if "*" in p:
            out.append(ctypes.c_void_p)
        elif p.startswith("long long"):
            out.append(ctypes.c_longlong)
        elif p.startswith("float"):
            out.append(ctypes.c_float)
        else:
            assert p.startswith("int "), p
            out.append(ctypes.c_int)
    return out


@pytest.mark.parametrize("src,table", [
    ("topk_rows.cu", "_TOPK_ARGS"), ("apply_rows.cu", "_APPLY_ARGS"),
    ("opaque_copy.cu", "_COPY_ARGS"), ("ladder_counts.cu", "_LADDER_ARGS"),
    ("select_pack_rows.cu", "_SELECT_ARGS"),
    ("dgc_forward_rows.cu", "_FORWARD_ARGS")])
def test_launch_argtypes_match_the_c_signatures(src, table):
    """Each wrapper's ctypes table against its kernel's C launch function
    (a count or type that differs only shows on the card)."""
    for fn, types in getattr(tk, table).items():
        assert types == _c_params(src, fn), fn
