"""The port's per-tensor exchange against the JAX package's.

``DistributedOptimizer.exchange`` over ``LocalComm(8)`` against the JAX
per-tensor ``DistributedOptimizer.exchange`` at W=8, on ResNet-20's
parameters (the conv and dense kernels compressed, the rest dense), 3
steps from the same gradients: nesterov x momentum masking crossed with
the int8 wire (with and without error feedback) and the fp16 wire, the
bf16 memory, and a sampled configuration (ratio 0.001,
``sample_ratio=0.01``) with the JAX-drawn strided phases passed in.

The JAX side runs op by op (``jax.vmap`` over a named axis, no ``jax.jit``:
under jit XLA-CPU contracts the compensate's multiply-adds into FMAs, which
the port does not). Memory is bitwise; the exchanged gradient is bitwise
apart from coordinates several workers sent, whose sums ``index_add_`` and
the reference's scatter may take in other orders (rtol 1e-6 there), and,
on the fp16 wire, the dense tensors' fp16 sums (within two fp16
roundings). Fused and unfused payloads are bitwise each other. One case
runs the JAX exchange jitted under ``shard_map`` on the 8-device mesh, as
test_flat.py:237-248 does, within that test's rtol 1e-5 / atol 1e-6.
The cases are spread over this file, test_torch_per_tensor_wires.py and
test_torch_per_tensor_sampled.py, which import its helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgc_tpu import DGCCompressor, DGCSGDMemory, DistributedOptimizer, dgc_sgd
from dgc_tpu.models import resnet20
from dgc_tpu.utils.compat import shard_map
from dgc_tpu.utils.pytree import named_flatten as jax_named_flatten
from dgc_tpu.utils.pytree import named_unflatten as jax_named_unflatten
from dgc_tpu_torch.compression import dgc as tdgc
from dgc_tpu_torch.compression.memory import DGCSGDMemory as TMemory
from dgc_tpu_torch.interop import carry_memory
from dgc_tpu_torch.optim.distributed import DistributedOptimizer as TDist
from dgc_tpu_torch.optim.sgd import dgc_sgd as t_dgc_sgd
from dgc_tpu_torch.parallel.comm import LocalComm

W = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of these exchanges is many small CPU ops, which run
    no faster on several threads (and these files run beside other test
    workers): one intra-op thread, restored afterwards. CPU results do
    not depend on it (the port's float sums here are sequential)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    v = resnet20().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True)
    return jax.device_get(v)


def _bits(x):
    if torch.is_tensor(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.name == "bfloat16" else np.int32)


def _compressors(params, ratio, sample_ratio, mem, comp):
    named = jax_named_flatten(params)[0]
    jc = DGCCompressor(ratio, memory=DGCSGDMemory(momentum=0.9, **mem),
                       sample_ratio=sample_ratio, **comp)
    jc.initialize((n, p) for n, p in named.items() if p.ndim > 1)
    tcs = []
    for _ in range(2):                     # fused and unfused payloads
        tc = tdgc.DGCCompressor(ratio, memory=TMemory(momentum=0.9, **mem),
                                sample_ratio=sample_ratio, **comp)
        tc.initialize((n, p.shape) for n, p in named.items() if p.ndim > 1)
        tcs.append(tc)
    return jc, tcs


def _jax_step(jdist, mesh=None):
    def worker(grads, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        return jdist.exchange(grads, mem, key)
    if mesh is None:
        # op by op (no jax.jit), see the module docstring
        return jax.vmap(worker, in_axes=(0, 0, None), axis_name="data")

    def per_device(grads, mem, key):
        out = worker(jax.tree.map(lambda x: x[0], grads),
                     jax.tree.map(lambda x: x[0], mem), key)
        return jax.tree.map(lambda x: x[None], out)
    return jax.jit(shard_map(per_device, mesh=mesh,
                             in_specs=(P("data"), P("data"), P()),
                             out_specs=(P("data"), P("data")),
                             check_vma=False))


def _phases(tc, names, key):
    """Per worker, the strided phase JAX's exchange draws for each sampled
    tensor: ``randint(fold_in(fold_in(key, w), i), (), 0, stride)``, i the
    tensor's index among all gradients."""
    out = []
    for w in range(W):
        kw = jax.random.fold_in(key, w)
        out.append({n: int(jax.random.randint(
            jax.random.fold_in(kw, i), (), 0, tc.attributes[n].sample_stride,
            dtype=jnp.int32)) for i, n in enumerate(names)
            if n in tc.attributes
            and tc.attributes[n].numel > tc.attributes[n].num_samples})
    return out


#: nesterov x momentum masking crossed with the wires; ``unfused`` also
#: runs the exchange with ``fuse_payloads=False`` and holds it bitwise
CASES = {
    "plain": dict(unfused=True),
    "nesterov_int8_no_feedback": dict(
        mem=dict(nesterov=True),
        comp=dict(int8_values=True, int8_error_feedback=False),
        unfused=True),
    "no_masking_int8": dict(mem=dict(momentum_masking=False),
                            comp=dict(int8_values=True), unfused=True),
    "nesterov_no_masking_fp16": dict(
        mem=dict(nesterov=True, momentum_masking=False),
        comp=dict(fp16_values=True)),
    "bf16_memory": dict(mem=dict(dtype="bfloat16")),
    "sampled": dict(ratio=0.001, sample_ratio=0.01),
}


def _run(params, case, steps, mesh=None):
    """Run both exchanges ``steps`` times; check memory and gradients."""
    named, treedef = jax_named_flatten(params)
    names = list(named)
    jc, (tc, tcu) = _compressors(params, case.get("ratio", 0.05),
                                 case.get("sample_ratio", 1.0),
                                 case.get("mem", {}), case.get("comp", {}))
    jdist = DistributedOptimizer(dgc_sgd(0.1), jc, world_size=W)
    tdist = TDist(t_dgc_sgd(0.1), tc, LocalComm(W))
    udist = TDist(t_dgc_sgd(0.1), tcu, LocalComm(W), fuse_payloads=False)
    jstep = _jax_step(jdist, mesh)
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W),
                        jdist.init_memory(params))
    tmems = [tdist.init_memory(params) for _ in range(W)]
    umems = [udist.init_memory(params) for _ in range(W)]
    # the valid indices each worker selects, per tensor
    sent = {}
    sparsify = tc.sparsify

    def recording(grad, name, phase=0):
        vals, idx, valid = sparsify(grad, name, phase)
        sent.setdefault(name, []).append(idx[valid].numpy())
        return vals, idx, valid
    tc.sparsify = recording
    rng = np.random.RandomState(7)
    exact = mesh is None
    for step in range(steps):
        grads = {n: rng.randn(W, *p.shape).astype(np.float32)
                 for n, p in named.items()}
        key = jax.random.PRNGKey(step)
        jout, jmem = jstep(jax_named_unflatten(
            {n: jnp.asarray(g) for n, g in grads.items()}, treedef), jmem,
            key)
        jout = jax_named_flatten(jout)[0]
        phases = _phases(tc, names, key)
        tgrads = [{n: torch.from_numpy(grads[n][w]) for n in names}
                  for w in range(W)]
        sent.clear()
        touts, tmems = tdist.exchange(tgrads, tmems, phases)
        if case.get("unfused"):
            uouts, umems = udist.exchange(tgrads, umems, phases)
        for w in range(W if case.get("unfused") else 0):
            for n in names:
                np.testing.assert_array_equal(_bits(touts[w][n]),
                                              _bits(uouts[w][n]))
                for key_ in ("momentums", "velocities"):
                    np.testing.assert_array_equal(
                        _bits(tmems[w][key_][n]), _bits(umems[w][key_][n]))
        for n in names:
            want = np.asarray(jout[n], np.float32)
            dup = np.zeros(named[n].size, bool)
            if n in sent:
                u, c = np.unique(np.concatenate(sent[n]), return_counts=True)
                dup[u[c > 1]] = True
            for w in range(W):
                got = touts[w][n].numpy().reshape(-1)
                ref = want[w].reshape(-1)
                if not exact:
                    np.testing.assert_allclose(got, ref, rtol=1e-5,
                                               atol=1e-6, err_msg=n)
                elif n not in tc.attributes and tc.fp16_values:
                    # fp16 sums of 8 workers: within two fp16 roundings
                    np.testing.assert_allclose(got, ref, rtol=2 ** -9,
                                               atol=0, err_msg=n)
                else:
                    np.testing.assert_array_equal(
                        got[~dup].view(np.int32), ref[~dup].view(np.int32),
                        err_msg=f"step {step} {n}")
                    np.testing.assert_allclose(got[dup], ref[dup],
                                               rtol=1e-6, atol=0, err_msg=n)
                for key_ in ("momentums", "velocities"):
                    t = tmems[w][key_][n]
                    j = np.asarray(jmem[key_][n][w])
                    assert t.dtype == getattr(torch, j.dtype.name)
                    if exact:
                        np.testing.assert_array_equal(
                            _bits(t), _bits(j), err_msg=f"{key_} {n}")
                    else:
                        np.testing.assert_allclose(
                            t.float().numpy(), np.asarray(j, np.float32),
                            rtol=1e-5, atol=1e-6, err_msg=f"{key_} {n}")
    return jmem, tmems


def check_case(params, name):
    """One case of :data:`CASES`: 3 steps, then the final memory carried
    from the JAX package equals the port's."""
    jmem, tmems = _run(params, CASES[name], steps=3)
    carried = carry_memory(jax.device_get(
        jax.tree.map(lambda x: x[W - 1], jmem)))
    for key in ("momentums", "velocities"):
        for n, t in tmems[W - 1][key].items():
            np.testing.assert_array_equal(_bits(carried[key][n]), _bits(t))


# the other cases are in test_torch_per_tensor_wires.py and
# test_torch_per_tensor_sampled.py, so that test workers share them out
@pytest.mark.parametrize("name", ["plain", "nesterov_int8_no_feedback"])
def test_exchange_matches_jax(variables, name):
    check_case(variables["params"], name)
