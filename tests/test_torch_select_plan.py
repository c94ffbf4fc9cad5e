"""The launch plan of the select-and-pack and forward kernels, and their
plain versions at the plan's slice boundaries.

``select_pack_rows`` and ``dgc_forward_rows`` run the top-k kernel's body
(``csrc/topk_select.cuh``) on its route and geometry,
``kernels.topk_plan(R, cols, k)``. The plan is pure arithmetic, checked at
every call shape the fused routes give the two kernels (ResNet-20 and
ResNet-50 at epochs 3-5, the megakernel gate's widest row and an
empty-row bucket: 13 shapes) and at the extremes (k = 1 and k = 1,024,
128 to 131,072 columns, 1 to 64 rows): each shape gets a route, its shared
memory fits one block's 227 KB, a cluster has at most 8 blocks and divides
the grid, slices are multiples of 4 columns, and the survivors are
bitonic-sorted (no scratch). The forward kernel compensates each slice in
float4s that share one row of the transmit record and must stage its
slice: every shape the megakernel's gate admits gets a staged plan.

The plain versions (what the wrappers run on CPU tensors and what the
kernels are held bitwise against on the card) are held bitwise against the
JAX package's ``select_pack_rows``, ``_select_pack_rows_mr`` and
``dgc_forward_rows``, run as test_torch_megakernel.py runs them (the Pallas
kernels in interpret mode; the forward kernel's state within the FMA bound
there, its selection bitwise), on rows with ties of the largest |x| planted
at columns cols/C*j - 1, cols/C*j and cols/C*j + 1 around the plan's C
slices and a row whose valid columns end inside a non-first slice.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu.ops import kernels as jk
from dgc_tpu_torch.ops import kernels as tk

SMEM_MAX = 227 * 1024
EPS4 = 4 * np.finfo(np.float32).eps

#: (rows, cols, k) of every select_pack_rows / dgc_forward_rows call of the
#: fused routes (ResNet-20 at epochs 3-5, then ResNet-50's), the megakernel
#: gate's widest row and the empty-row bucket of chip_smoke.py
SELECT_SHAPES = [
    (6, 36864, 369), (16, 9216, 93), (6, 36864, 117), (16, 9216, 30),
    (6, 36864, 37), (16, 9216, 10),
    (11, 65536, 656), (8, 16384, 164), (11, 65536, 208), (8, 16384, 52),
    (8, 16384, 17),
    (2, 131072, 1024), (3, 16384, 164)]
#: the widest row the megakernel's gate admits (flat.py's _MK_MAX_COLS)
MK_MAX_COLS = 128 * 1024


def _check_plan(R, cols, k, plan):
    assert plan.route in tk.TOPK_ROUTES
    assert plan.smem_bytes <= SMEM_MAX and plan.smem_bytes % 16 == 0
    assert 1 <= plan.cluster <= 8 and plan.grid == R * plan.cluster
    assert plan.grid % plan.cluster == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert not plan.radix                 # bitonic: no global scratch
    assert plan.padded & (plan.padded - 1) == 0
    if plan.route == "sort":
        assert cols <= plan.padded <= tk.TOPK_SORT_MAX_COLS
    else:
        assert k <= plan.padded <= tk.MR_MAX_K
    assert plan.slice % 4 == 0 or plan.cluster == 1
    assert plan.slice * plan.cluster >= cols
    assert (plan.cluster - 1) * plan.slice < cols      # no empty block
    if plan.cluster == 1:
        assert plan.slice == cols


def test_select_shapes_are_the_fused_routes_calls():
    """SELECT_SHAPES[:11] are the buckets the megakernel and the fused
    select take at ResNet-20's and ResNet-50's epoch-3 to -5 ratios, as
    chip_smoke.py enumerates them."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    both = dict(megakernel=True, fused_select=True)
    got = [(R, cols, k) for model, recipe in (("resnet20", "resnet20_wm5"),
                                              ("resnet50", "resnet50_wm5"))
           for _, R, cols, _, _, k in chip_smoke._select_cases(
               model, chip_smoke._geometries(recipe, (3, 4, 5), **both))]
    assert got == SELECT_SHAPES[:11]


@pytest.mark.parametrize("R,cols,k", SELECT_SHAPES)
def test_select_plan_at_path_shapes(R, cols, k):
    plan = tk.topk_plan(R, cols, k)
    _check_plan(R, cols, k, plan)
    assert plan.staged
    # the wide rows of a few-row bucket spread over clusters
    assert plan.route == "cluster"


@pytest.mark.parametrize("R", [1, 2, 3, 17, 64])
@pytest.mark.parametrize("cols", [128, 512, 640, 2048, 8192, 36864, 65536,
                                  131072])
def test_select_plan_extremes(R, cols):
    for k in (1, min(cols, tk.MR_MAX_K)):
        _check_plan(R, cols, k, tk.topk_plan(R, cols, k))


@pytest.mark.parametrize("R", [1, 2, 3, 6, 11, 16, 33, 64, 200])
def test_forward_plan_stages_every_admitted_shape(R):
    """Every lane-aligned width up to the gate's, at k = 1, 37 and the
    largest: a staged, bitonic-sorted plan whose slices start on a float4
    (with base and cols multiples of 128, a float4 then shares one
    128-lane row of the transmit record)."""
    for cols in range(128, MK_MAX_COLS + 1, 128):
        for k in {1, min(cols, 37), min(cols, tk.MR_MAX_K)}:
            plan = tk.topk_plan(R, cols, k)
            assert plan.staged and not plan.radix, (R, cols, k, plan)
            assert plan.slice % 4 == 0 and plan.smem_bytes <= SMEM_MAX
            assert plan.slice * plan.cluster >= cols


def _boundary_ties(cols, cluster):
    return sorted({c for j in range(cluster + 1)
                   for c in (cols // cluster * j - 1, cols // cluster * j,
                             cols // cluster * j + 1) if 0 <= c < cols})


def _tail(cols, cluster):
    """Valid columns ending inside the second slice, off a multiple of 4."""
    return (cols // cluster + cols // (2 * cluster) if cluster > 1
            else cols // 2) + 3


def _select_rows(R, cols, k, seed):
    """R >= 3 rows of few distinct levels (many ties), signs mixed: row 0
    with the largest |x| planted at the plan's slice boundaries (signs
    alternating), row 1 the same ties and a tail that ends inside the
    second slice, row 2 one valid column, -0.0 (selected first)."""
    plan = tk.topk_plan(R, cols, k)
    rng = np.random.RandomState(seed)
    x = (rng.randint(1, 60, (R, cols)) / 7.0).astype(np.float32)
    x *= rng.choice(np.float32([-1, 1]), (R, cols))
    ties = _boundary_ties(cols, plan.cluster)
    for r in (0, 1):
        x[r, ties] = np.where(np.arange(len(ties)) % 2, -9.0, 9.0)
    x[2, 0] = -0.0
    numels = np.full(R, cols, np.int32)
    numels[1] = _tail(cols, plan.cluster)
    numels[2] = 1
    return x, numels, ties, plan


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("R,cols,k", [
    (3, 16384, 1), (3, 16384, 37), (3, 16384, 164), (4, 9216, 10),
    (4, 9216, 93), (3, 36864, 369), (3, 8192, 1024), (3, 512, 66)])
def test_select_plain_matches_jax_at_slice_boundaries(R, cols, k):
    """Bitwise against the Pallas kernels: ``select_pack_rows`` (which
    takes the chunked kernel for k > 128) and ``_select_pack_rows_mr``
    itself; the planted ties come first in column order, across slices,
    and a selected -0.0 is written +0.0."""
    x, numels, ties, plan = _select_rows(R, cols, k, cols + k)
    got = tk.select_pack_rows(torch.from_numpy(x), torch.from_numpy(numels),
                              k)
    for fn in (jk.select_pack_rows, jk._select_pack_rows_mr):
        want = fn(jnp.asarray(x), jnp.asarray(numels), k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    cols0 = got[2].numpy()
    np.testing.assert_array_equal(cols0[0, :min(k, len(ties))],
                                  ties[:k])
    valid = [c for c in ties if c < numels[1]]
    np.testing.assert_array_equal(cols0[1, :min(k, len(valid))], valid[:k])
    assert cols0[2, 0] == 0 and _bits(got[1].numpy())[2, 0] == 0
    assert {c // plan.slice for c in ties} == set(range(plan.cluster))


def _forward_inputs(R, cols, k, base, seed):
    """The forward kernel's state: g = +-50 with m = v = 0 at the plan's
    slice boundaries of rows 0 and 1 (equal |v'|, far above the rest, under
    every momentum flag, with or without FMA contraction), row 1's valid
    columns ending inside the second slice, a random transmit record that
    runs past the region."""
    plan = tk.topk_plan(R, cols, k)
    rng = np.random.RandomState(seed)
    n = R * cols
    g, m, v = (rng.randn(n).astype(np.float32) for _ in range(3))
    ties = _boundary_ties(cols, plan.cluster)
    for r in (0, 1):
        for j, c in enumerate(ties):
            g[r * cols + c] = -50.0 if j % 2 else 50.0
            m[r * cols + c] = v[r * cols + c] = 0.0
    bits = rng.randint(-2 ** 31, 2 ** 31, size=jk.num_sent_words(
        base + n + 512), dtype=np.int64).astype(np.int32)
    numels = np.full(R, cols, np.int32)
    numels[1] = _tail(cols, plan.cluster)
    return g, m, v, bits, numels, ties


@pytest.mark.parametrize("R,cols,k,base", [
    (2, 9216, 10, 0), (3, 9216, 93, 640), (2, 16384, 164, 4096),
    (2, 8192, 1024, 128 * 33), (3, 512, 66, 384)])
@pytest.mark.parametrize("nesterov", [False, True])
def test_forward_plain_matches_jax_at_slice_boundaries(R, cols, k, base,
                                                       nesterov):
    """Bitwise against the op-by-op ``dgc_forward_rows_reference`` (state
    in place; values as the kernel reads them, -0.0 as +0.0), and against
    the Pallas kernel: state within 4 eps (|m| + |g| + |v|), the FMA bound
    of test_torch_kernels.py, and its selection bitwise the port's
    ``select_pack_rows`` over the kernel's own velocity."""
    g, m, v, bits, numels, ties = _forward_inputs(R, cols, k, base,
                                                  cols + k + base)
    args = (jnp.asarray(numels), k, 0.9)
    ref = jk.dgc_forward_rows_reference(
        *(jnp.asarray(a) for a in (g, m, v, bits)), base, *args,
        nesterov=nesterov)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    sel = tk.dgc_forward_rows(torch.from_numpy(g), tm, tv,
                              torch.from_numpy(bits), base,
                              torch.from_numpy(numels), k, 0.9,
                              nesterov=nesterov)
    for got, w in zip((tm, tv, sel[0], sel[2]), (*ref[:3], ref[4])):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(w))
    np.testing.assert_array_equal(_bits(sel[1].numpy()),
                                  _bits(np.asarray(ref[3]) + np.float32(0)))
    np.testing.assert_array_equal(sel[2][0, :min(k, len(ties))].numpy(),
                                  ties[:k])
    km, kv, *ksel = jk.dgc_forward_rows(
        *(jnp.asarray(a) for a in (g, m, v, bits)), base, *args,
        nesterov=nesterov)
    bound = EPS4 * (np.abs(m) + np.abs(g) + np.abs(v))
    assert (np.abs(np.asarray(km) - tm.numpy()) <= bound).all()
    assert (np.abs(np.asarray(kv) - tv.numpy()) <= bound).all()
    again = tk.select_pack_rows(torch.from_numpy(np.array(kv)).view(R, cols),
                                torch.from_numpy(numels), k)
    for a, b in zip(again, ksel):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
