"""The port's megakernel slice against the JAX package, on the CPU (the
kernels' plain versions; JAX's Pallas kernels in interpret mode and their
jnp references):

* ``realign_bits`` bitwise against the JAX function;
* ``select_pack_rows`` (its plain version) bitwise against the Pallas
  kernel in both of its regimes, the single-block kernel and the chunked
  multi-round one;
* ``dgc_forward_rows`` (its plain version) bitwise against the op-by-op
  ``dgc_forward_rows_reference``, and against the Pallas kernel: state
  within the FMA bound of test_torch_kernels.py (XLA contracts
  ``momentum * m + g`` under jit), selection bitwise on the kernel's own
  velocity;
* the engine's routing gates against the JAX engine's on-card gates, and
  the W=8 exchange with ``megakernel=True`` or ``fused_select=True``
  against the port's default engine and the JAX default engine;
* the recipes, the CLI flags and ``DGC_MEGAKERNEL=1``.

A selected -0.0 reads +0.0 from the Pallas select kernels (a one-hot
masked sum), and so from the port's; the jnp references gather it and keep
the sign. A comparison with a reference or with the default engine's
payload therefore reads the values as numbers where it says so."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu import DGCCompressor, DGCSGDMemory
from dgc_tpu.compression.flat import FlatDGCEngine, ParamLayout
from dgc_tpu.models import resnet20, resnet50
from dgc_tpu.ops import kernels as jk
from dgc_tpu.utils.config import Config, configs
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu_torch import configs as tconfigs
from dgc_tpu_torch import train as ttrain
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression import flat as tflat
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the file runs beside other test workers, where
    several threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS4 = 4 * np.finfo(np.float32).eps
W = 8


def _bits(x):
    return np.asarray(x).view(np.int32)


def _as_kernel_reads(x):
    """A reference's values as the select kernels read them: -0.0 is
    +0.0."""
    return _bits(np.asarray(x) + np.float32(0.0))


def _rand_bits(rng, total):
    w = jk.num_sent_words(total)
    return rng.randint(-2 ** 31, 2 ** 31, size=w,
                       dtype=np.int64).astype(np.int32)


# ------------------------------------------------------------------ #
# realign_bits                                                       #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("row", [0, 5, 31, 64, 69, 95])   # row % 32: 0, 5, 31
@pytest.mark.parametrize("n", [128, 12544, 32768])
def test_realign_bits_matches_jax(row, n):
    """The window of a 32,768-element record at ``base = 128 * row``;
    n = 32,768 runs past the record's end (words there read 0)."""
    total = 32768
    bits = _rand_bits(np.random.RandomState(row * 7 + n), total)
    base = 128 * row
    got = tk.realign_bits(torch.from_numpy(bits), base, n)
    assert got.dtype == torch.int32 and got.shape == (tk.num_sent_words(n),)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jk.realign_bits(jnp.asarray(bits), base, n)))
    keep = tk.keep_from_bits(got, n).numpy()
    full = tk.keep_from_bits(torch.from_numpy(bits), total).numpy()
    inside = min(n, total - base)
    np.testing.assert_array_equal(keep[:inside], full[base:base + inside])
    assert (keep[inside:] == 1.0).all()


# ------------------------------------------------------------------ #
# select_pack_rows                                                   #
# ------------------------------------------------------------------ #

def _select_input(rng, cols, k):
    """Five rows: a full one with the largest |x| planted as ties across
    16,384-column chunks (signs mixed), a ragged one, one whose only valid
    entry is -0.0 (selected whatever k), an empty one (``numels = 0``:
    k tail slots in column order) and a short one (fewer than k valid
    entries when k > 20). Few distinct levels: many ties."""
    x = (rng.randint(1, 60, (5, cols)) / 7.0).astype(np.float32)
    x *= rng.choice(np.float32([-1, 1]), (5, cols))
    for c, sign in ((100, 1), (16484, -1), (32868, 1), (cols - 1, -1)):
        if c < cols:
            x[0, c] = sign * 9.0
    x[2, 0] = -0.0
    numels = np.array([cols, cols - 77, 1, 0, 20], np.int32)
    return x, numels


@pytest.mark.parametrize("cols,k,regime", [
    (1000, 1, "single"), (1000, 37, "single"), (2048, 128, "single"),
    (20000, 37, "single"), (20000, 129, "chunked"), (36864, 369, "chunked"),
    (3000, 1024, "chunked"), (20000, 1024, "chunked")])
def test_select_pack_rows_matches_pallas(cols, k, regime, monkeypatch):
    """Bitwise against the Pallas kernel (interpret mode), which reaches
    ``_select_pack_rows_mr`` for k > 128 (asserted); against the jnp
    reference bitwise in scores and columns, and in values as the kernel
    reads them (the selected -0.0 of row 2 as +0.0)."""
    x, numels = _select_input(np.random.RandomState(cols + k), cols, k)
    calls = []
    mr = jk._select_pack_rows_mr
    monkeypatch.setattr(jk, "_select_pack_rows_mr",
                        lambda *a: calls.append(1) or mr(*a))
    want = jk.select_pack_rows(jnp.asarray(x), jnp.asarray(numels), k)
    assert bool(calls) == (regime == "chunked")
    got = tk.select_pack_rows(torch.from_numpy(x), torch.from_numpy(numels),
                              k)
    assert [t.dtype for t in got] == [torch.float32, torch.float32,
                                      torch.int32]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    rs, rv, rc = jk.select_pack_rows_reference(jnp.asarray(x),
                                               jnp.asarray(numels), k)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(rs))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(rc))
    np.testing.assert_array_equal(_bits(got[1].numpy()), _as_kernel_reads(rv))
    # row 2 selects its -0.0 first: the reference keeps the sign
    assert got[2][2, 0] == 0 and _bits(rv)[2, 0] == _bits(np.float32(-0.0))
    assert _bits(got[1].numpy())[2, 0] == 0
    # the empty row: k tail slots (importance -1) in column order
    np.testing.assert_array_equal(got[2][3].numpy(), np.arange(k))
    assert (got[0][3] == -1.0).all()


def test_select_pack_rows_checks_arguments():
    x = torch.zeros(2, 2048)
    n = torch.full((2,), 2048, dtype=torch.int32)
    for k in (0, tk.MR_MAX_K + 1):
        with pytest.raises(ValueError):
            tk.select_pack_rows(x, n, k)
    with pytest.raises(ValueError):
        tk.select_pack_rows(torch.zeros(2, 64), n, 65)
    with pytest.raises(ValueError):
        tk.select_pack_rows(x, n.long(), 4)


# ------------------------------------------------------------------ #
# dgc_forward_rows                                                   #
# ------------------------------------------------------------------ #

# test_megakernel.py's five shapes, and the widest k
FWD_CASES = [(1, 128, 0, [128], 1), (2, 256, 640, [256, 100], 16),
             (3, 256, 128, [256, 100, 0], 8), (1, 512, 0, [512], 129),
             (2, 384, 4096, [288, 320], 19), (1, 1024, 0, [1024], 1024)]
FLAGS = [dict(nesterov=n, momentum_masking=mm)
         for n in (False, True) for mm in (False, True)]


def _fwd_inputs(R, cols, base, seed):
    rng = np.random.RandomState(seed)
    n = R * cols
    g, m, v = (rng.randn(n).astype(np.float32) for _ in range(3))
    return g, m, v, _rand_bits(rng, base + n + 512)


@pytest.mark.parametrize("case", FWD_CASES)
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "n%d-mm%d" % (
    f["nesterov"], f["momentum_masking"]))
def test_dgc_forward_rows_matches_reference(case, flags):
    """Bitwise against the op-by-op jnp reference, state in place; values
    as the kernel reads them."""
    R, cols, base, numels, k = case
    g, m, v, bits = _fwd_inputs(R, cols, base, 3 + R + k)
    numels = np.asarray(numels, np.int32)
    want = jk.dgc_forward_rows_reference(
        *(jnp.asarray(a) for a in (g, m, v, bits)), base,
        jnp.asarray(numels), k, 0.9, **flags)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    sel = tk.dgc_forward_rows(torch.from_numpy(g), tm, tv,
                              torch.from_numpy(bits), base,
                              torch.from_numpy(numels), k, 0.9, **flags)
    for got, w in zip((tm, tv, sel[0], sel[2]), (*want[:3], want[4])):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(w))
    np.testing.assert_array_equal(_bits(sel[1].numpy()),
                                  _as_kernel_reads(want[3]))


@pytest.mark.parametrize("case", FWD_CASES)
def test_dgc_forward_rows_matches_pallas(case):
    """Against the Pallas kernel (interpret mode, under jit): m and v
    within 4 eps (|m| + |g| + |v|), the FMA bound of
    test_torch_kernels.py; its selection bitwise the port's
    ``select_pack_rows`` over the kernel's own velocity."""
    R, cols, base, numels, k = case
    g, m, v, bits = _fwd_inputs(R, cols, base, 5 + R + k)
    numels = np.asarray(numels, np.int32)
    km, kv, ks, kvals, kc = jk.dgc_forward_rows(
        *(jnp.asarray(a) for a in (g, m, v, bits)), base,
        jnp.asarray(numels), k, 0.9)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    tk.dgc_forward_rows(torch.from_numpy(g), tm, tv, torch.from_numpy(bits),
                        base, torch.from_numpy(numels), k, 0.9)
    bound = EPS4 * (np.abs(m) + np.abs(g) + np.abs(v))
    assert (np.abs(np.asarray(km) - tm.numpy()) <= bound).all()
    assert (np.abs(np.asarray(kv) - tv.numpy()) <= bound).all()
    sel = tk.select_pack_rows(torch.from_numpy(np.array(kv)).view(R, cols),
                              torch.from_numpy(numels), k)
    for a, b in zip(sel, (ks, kvals, kc)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_dgc_forward_rows_refuses_narrow_state():
    z = torch.zeros(128)
    bits = torch.zeros(128, dtype=torch.int32)
    n = torch.tensor([128], dtype=torch.int32)
    for args in ((z.bfloat16(), z, z), (z, z.bfloat16(), z)):
        with pytest.raises(ValueError, match="f32-only"):
            tk.dgc_forward_rows(*args, bits, 0, n, 4, 0.9)


# ------------------------------------------------------------------ #
# the engine                                                         #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def trees():
    return {"resnet20": jax.eval_shape(lambda: resnet20().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True)
    )["params"], "resnet50": jax.eval_shape(lambda: resnet50().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True)
    )["params"]}


def _compressors(tree, epoch, **flags):
    kw = dict(sample_ratio=0.01, warmup_epochs=5, **flags)
    jc = DGCCompressor(0.001, memory=DGCSGDMemory(momentum=0.9), **kw)
    tc = tdgc.DGCCompressor(0.001, memory=TMemory(momentum=0.9), **kw)
    named = jax_named_flatten(tree)[0]
    jc.initialize((n, p) for n, p in named.items() if len(p.shape) > 1)
    tc.initialize((n, p.shape) for n, p in named.items() if len(p.shape) > 1)
    jc.warmup_compress_ratio(epoch)
    tc.warmup_compress_ratio(epoch)
    return jc, tc


def _jax_engine(tree, jc):
    return FlatDGCEngine(jc, ParamLayout.for_compressor(tree, jc))


def _engine(tree, tc):
    return tflat.FlatDGCEngine(tc, tflat.ParamLayout.for_compressor(tree, tc))


@pytest.mark.parametrize("name,epoch,owned,fused", [
    ("resnet20", 2, (1,), [False, True]),
    ("resnet20", 3, (0, 1), [True, True]),
    ("resnet20", 4, (0, 1), [True, True]),
    ("resnet20", 5, (0, 1), [True, True]),
    ("resnet50", 3, (5, 6), None),
    ("resnet50", 4, (5, 6), None),
    ("resnet50", 5, (6,), None)])
def test_gates_match_the_jax_engine_on_the_card(trees, name, epoch, owned,
                                                fused, monkeypatch):
    """``_mk_fwd_ids`` and the fused-select choice of every bucket equal
    the JAX engine's gates as they decide on a TPU (``_interpret``
    patched to False around the gate calls; nothing is launched)."""
    jc, tc = _compressors(trees[name], epoch, megakernel=True,
                          fused_select=True)
    je, te = _jax_engine(trees[name], jc), _engine(trees[name], tc)
    with monkeypatch.context() as mp:
        mp.setattr(jk, "_interpret", lambda: False)
        j_owned = tuple(bi for bi in je._sparse_ids
                        if je._use_megakernel_fwd(bi))
        j_fused = [je._use_fused_select(b) for b in je.buckets]
    assert te._mk_fwd_ids == j_owned == owned
    got = [te._use_fused_select(b) for b in te.buckets]
    assert got == j_fused
    if fused is not None:
        assert got == fused
    for bi in owned:
        assert not te._seg[bi]


def test_jax_engine_built_on_the_cpu_owns_fewer_buckets(trees):
    """The JAX engine built here applies its interpreter's work bound
    (rows * cols * k <= 5e7): at ResNet-20's epoch 3 it gives the
    [6, 36864] bucket (k = 369) back to the unfused path, which the port,
    like the JAX engine on a TPU, runs through the megakernel."""
    jc, tc = _compressors(trees["resnet20"], 3, megakernel=True)
    je, te = _jax_engine(trees["resnet20"], jc), _engine(trees["resnet20"], tc)
    b = te.buckets[0]
    assert (b.rows, b.cols, b.max_sel) == (6, 36864, 369)
    assert je._mk_fwd_ids == (1,) and te._mk_fwd_ids == (0, 1)


def _jax_phases(je, key):
    return [[[] if b.exact else [
        float(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, w), bi), gi), ()))
        for gi in range(len(b.stride_groups))]
        for bi, b in enumerate(je.buckets)] for w in range(W)]


def _jax_step(je):
    """The JAX default engine's W=8 exchange, op by op (no jit: XLA-CPU
    would contract its multiply-adds) over a vmapped named axis."""
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        vals, idx = je.sparsify(je._compensate_acc(
            mem["momentums_c"], mem["velocities_c"], fg,
            mem["sent_bits"])[2], key)
        out, mem = je.exchange(fg, mem, key, "data", W)
        return out, mem, vals, idx
    return jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")


def _port_step(te, grads, mems, phases):
    """One W=8 step of the port's engine: each worker's payload (from a
    snapshot of its memory) and the exchange; ``mems`` update in place."""
    pre = [{k: v.clone() for k, v in m.items()} for m in mems]
    sent = [te.compress(torch.from_numpy(grads[w]), pre[w], phases[w])
            for w in range(W)]
    outs = te.exchange([torch.from_numpy(g) for g in grads], mems, phases,
                       LocalComm(W))
    return sent, outs


_MEM_KEYS = ("momentums_c", "velocities_c", "momentums_d", "velocities_d",
             "sent_bits")


@pytest.mark.parametrize("epoch", [3, 5])
def test_fused_routes_match_the_default_and_jax_engines(trees, epoch):
    """ResNet-20's layout, W=8, two steps (the second masks the first's
    record on read): the ``megakernel=True`` and ``fused_select=True``
    engines bitwise the port's default engine — payload indices, memory,
    records, exchanged gradient; payload values as numbers, a selected
    -0.0 being +0.0 on the fused routes — and all three against the JAX
    default engine as test_torch_engine.py holds the default one: bitwise,
    apart from coordinates several workers sent (rtol 1e-6)."""
    tree = trees["resnet20"]
    jc, tc = _compressors(tree, epoch)
    je, default = _jax_engine(tree, jc), _engine(tree, tc)
    routes = {"default": default}
    for flag in ("megakernel", "fused_select"):
        routes[flag] = _engine(tree, _compressors(tree, epoch,
                                                  **{flag: True})[1])
    assert routes["megakernel"]._mk_fwd_ids == (0, 1)
    assert all(map(routes["fused_select"]._use_fused_select,
                   routes["fused_select"].buckets))
    assert not default._mk_fwd_ids
    P_, T, S = default.layout.total, default.T, default.layout.sentinel
    mems = {r: [e.init_memory("cpu") for _ in range(W)]
            for r, e in routes.items()}
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    step = _jax_step(je)
    rng = np.random.RandomState(epoch)
    for s in range(2):
        grads = rng.randn(W, P_).astype(np.float32)
        grads[:, T:] *= 0.1
        key = jax.random.PRNGKey(100 * epoch + s)
        jout, jmem, jvals, jidx = step(jnp.asarray(grads), jmem, key)
        phases = _jax_phases(je, key)
        res = {r: _port_step(e, grads, mems[r], phases)
               for r, e in routes.items()}
        real = np.asarray(jidx).reshape(-1)
        uniq, counts = np.unique(real[real != S], return_counts=True)
        dup = np.zeros(P_, bool)
        dup[uniq[counts > 1]] = True
        ref = np.asarray(jout[0])
        for r, (sent, outs) in res.items():
            d_sent, d_outs = res["default"]
            for w in range(W):
                np.testing.assert_array_equal(sent[w][0].numpy(),
                                              d_sent[w][0].numpy())
                np.testing.assert_array_equal(
                    _as_kernel_reads(sent[w][0].numpy()),
                    _as_kernel_reads(jvals[w]))
                np.testing.assert_array_equal(sent[w][1].numpy(),
                                              np.asarray(jidx[w]))
                for k in _MEM_KEYS:
                    np.testing.assert_array_equal(
                        _bits(mems[r][w][k].numpy()), _bits(jmem[k][w]),
                        err_msg=f"{r} {k}")
                got = outs[w].numpy()
                np.testing.assert_array_equal(_bits(got),
                                              _bits(d_outs[w].numpy()))
                np.testing.assert_array_equal(_bits(got[~dup]),
                                              _bits(ref[~dup]))
                np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6,
                                           atol=0)


def test_resnet50_megakernel_takes_the_standalone_candidates(trees,
                                                             monkeypatch):
    """ResNet-50's layout at ratio 0.001 on the megakernel route: the
    [8, 16384] bucket runs the forward megakernel, the six segment-path
    buckets compute their own candidates (``seg_top2_candidates``, not the
    fused compensate's), and one worker's payload, memory and record are
    bitwise the default engine's (payload values as numbers)."""
    tree = trees["resnet50"]
    default = _engine(tree, _compressors(tree, 5)[1])
    mk = _engine(tree, _compressors(tree, 5, megakernel=True)[1])
    assert mk._mk_fwd_ids == (6,) and sum(mk._seg) == 6
    calls = {"seg_top2_candidates": 0, "compensate_bits_cands": 0}
    for name in calls:
        fn = getattr(tk, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tk, name, spy)
    rng = np.random.RandomState(11)
    grad = torch.from_numpy(rng.randn(default.layout.total).astype(
        np.float32))
    m0 = torch.from_numpy(rng.randn(default.T).astype(np.float32))
    v0 = torch.from_numpy(rng.randn(default.T).astype(np.float32))
    out = {}
    for r, e in (("default", default), ("megakernel", mk)):
        mem = e.init_memory("cpu")
        mem["momentums_c"].copy_(m0)
        mem["velocities_c"].copy_(v0)
        phases = e.draw_phases(torch.Generator().manual_seed(3))
        before = dict(calls)
        vals, idx = e.compress(grad, mem, phases)
        e.apply(vals[None], idx[None], torch.zeros(e.layout.total - e.T),
                mem, 0, 1)
        out[r] = (vals, idx, mem)
        used = {k: calls[k] - before[k] for k in calls}
        assert used == ({"seg_top2_candidates": 0, "compensate_bits_cands": 1}
                        if r == "default" else
                        {"seg_top2_candidates": 6, "compensate_bits_cands": 0})
    (dv, di, dm), (mv, mi, mm) = out["default"], out["megakernel"]
    np.testing.assert_array_equal(mv.numpy(), dv.numpy())
    np.testing.assert_array_equal(mi.numpy(), di.numpy())
    for k in ("momentums_c", "velocities_c", "sent_bits"):
        np.testing.assert_array_equal(_bits(mm[k].numpy()),
                                      _bits(dm[k].numpy()), err_msg=k)


# ------------------------------------------------------------------ #
# recipes and the CLI                                                #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("recipe,model_file", [
    ("resnet20_wm5_megakernel", "configs/cifar/resnet20.py"),
    ("resnet50_wm5_megakernel", "configs/imagenet/resnet50.py")])
def test_megakernel_recipes_match_the_config_files(recipe, model_file,
                                                   monkeypatch):
    """The recipe is its base recipe with the flag of
    ``configs/dgc/megakernel.py``; the compression group holds the config
    files' values."""
    monkeypatch.chdir(REPO)
    Config.reset()
    try:
        Config.update_from_modules(model_file, "configs/dgc/wm5.py",
                                   "configs/dgc/megakernel.py")
        c = configs.train.compression
        t = tconfigs.RECIPES[recipe]()
        for k in ("compress_ratio", "sample_ratio", "strided_sample",
                  "compress_upper_bound", "compress_lower_bound",
                  "max_adaptation_iters", "resample", "warmup_epochs",
                  "megakernel"):
            assert t.train.compression[k] == c[k], k
        assert t.train.compression.fused_select == c.get("fused_select",
                                                         False)
        assert t.model.name == configs.model.callable.__name__
    finally:
        Config.reset()
    base = tconfigs.RECIPES[recipe.replace("_megakernel", "")]()
    assert not base.train.compression.megakernel
    t.train.compression.megakernel = False
    assert t == base


def test_cli_flags_reach_the_compressor(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)     # the CLI's runs/ directory
    seen = []

    class Spy(ttrain.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)
    monkeypatch.setattr(ttrain, "Trainer", Spy)
    common = ["--device", "cpu", "--epochs", "0", "--synthetic-size", "64"]
    ttrain.main(common)
    ttrain.main(common + ["--megakernel", "--fused-select"])
    ttrain.main(common + ["--config", "resnet20_wm5_megakernel"])
    assert [(t.compression.megakernel, t.compression.fused_select)
            for t in seen] == [(False, False), (True, True), (True, False)]
    assert [t.setup.engine._mk_fwd_ids for t in seen] == [(), (0, 1), (0, 1)]


def test_env_opt_in(trees, monkeypatch):
    """``DGC_MEGAKERNEL=1`` turns the route on without the compressor's
    flag, as in the JAX engine."""
    tc = _compressors(trees["resnet20"], 5)[1]
    assert not _engine(trees["resnet20"], tc)._mk_fwd_ids
    monkeypatch.setenv("DGC_MEGAKERNEL", "1")
    te = _engine(trees["resnet20"], tc)
    assert te._megakernel and te._mk_fwd_ids == (0, 1)


@pytest.mark.parametrize("recipe,flags", [
    ("resnet20_wm5_megakernel", {}), ("resnet20_wm5", {"fused_select": True})])
def test_training_steps_equal_the_default_route(recipe, flags):
    """Two CPU steps at epoch 3 (ratio 0.01; W=2, batch 8) give bitwise the
    losses and weights of ``resnet20_wm5``."""
    def run(name, **kw):
        cfg = tconfigs.RECIPES[name]()
        cfg.train.batch_size = 8
        cfg.dataset.synthetic_size = 64
        cfg.train.compression.update(kw)
        trainer = ttrain.Trainer(cfg, LocalComm(2), device="cpu")
        losses = [float(x) for x in trainer.run_epoch(3, 2)]
        return trainer, losses
    base, want = run("resnet20_wm5")
    fused, got = run(recipe, **flags)
    assert fused.setup.engine._mk_fwd_ids or fused.compression.fused_select
    assert got == want
    assert torch.equal(fused.state.params.view(torch.int32),
                       base.state.params.view(torch.int32))
