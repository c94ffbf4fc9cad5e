"""A W=2 exchange over a split bucket against the op-by-op JAX engine, on
the CPU: one (2048, 4097) tensor, whose row of 8,519,680 columns the
segment split makes 2 segment rows of 4,259,840, at a warm-up epoch (the
3-D fallback on the segment rows; one step, as the reference's CPU
``approx_max_k`` over the block axis takes seconds) and at epoch 5 (the
segment path; two steps, the second masking the first's transmit record
on read). Bitwise, as
``test_torch_seg.py::test_seg_exchange_matches_jax_engine``, apart from
coordinates both workers sent, whose sums run in another order (rtol
1e-6). The gradients' magnitudes are distinct within each worker, so no
candidate tie is reached (``test_torch_wide.py`` holds the tie rule)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgc_tpu_torch.ops import kernels as tk
from dgc_tpu_torch.parallel.comm import LocalComm
from test_torch_seg import _bits, _engines, _jax_phases
from test_torch_wide import _distinct

W = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, restored afterwards (see test_torch_wide.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# the exchange over a split bucket                                   #
# ------------------------------------------------------------------ #

def _split_tree():
    """One (2048, 4097) tensor: 8,390,656 elements in a row of 8,519,680
    columns, split into 2 segment rows of 4,259,840; and a dense tail."""
    return {"w": {"kernel": np.zeros((2048, 4097), np.float32),
                  "bias": np.zeros((4097,), np.float32)}}


def _exchange_worker(engine):
    def worker(fg, mem, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        return engine.exchange(fg, mem, key, "data", W)
    return worker


@pytest.mark.parametrize("epoch,steps,sel3d", [(4, 1, True), (5, 2, False)])
def test_split_exchange_matches_jax_engine(epoch, steps, sel3d):
    """Every worker's exchanged gradient and memory after each step."""
    je, te = _engines(_split_tree(), epoch)
    b = te.buckets[0]
    assert (b.rows, b.cols) == (2, 4_259_840)
    assert te._sel3d == [sel3d] and te._seg == [not sel3d]
    T, P_, S = te.T, te.layout.total, te.layout.sentinel
    jmem = jax.tree.map(lambda x: jnp.stack([x] * W), je.init_memory())
    tmems = [te.init_memory("cpu") for _ in range(W)]
    step = jax.vmap(_exchange_worker(je), in_axes=(0, 0, None),
                    axis_name="data")
    rng = np.random.RandomState(epoch)
    for s in range(steps):
        grads = np.stack([_distinct(rng, P_) for _ in range(W)])
        key = jax.random.PRNGKey(40 + s)
        jout, jmem = step(jnp.asarray(grads), jmem, key)
        phases = [_jax_phases(je, jax.random.fold_in(key, w))
                  for w in range(W)]
        outs = te.exchange([torch.from_numpy(g) for g in grads], tmems,
                           phases, LocalComm(W))
        for w in range(W):
            for k in ("momentums_c", "velocities_c", "momentums_d",
                      "velocities_d", "sent_bits"):
                np.testing.assert_array_equal(
                    _bits(tmems[w][k].numpy()), _bits(jmem[k][w]),
                    err_msg=k)
        sent = [set(np.flatnonzero(tk.keep_from_bits(
            tmems[w]["sent_bits"], T).numpy() == 0)) for w in range(W)]
        dup = np.zeros(P_, bool)
        dup[sorted(sent[0] & sent[1])] = True
        assert len(sent[0]) > 1000 and S not in sent[0]
        ref = np.asarray(jout[0])
        for w in range(W):
            got = outs[w].numpy()
            np.testing.assert_array_equal(_bits(got[~dup]),
                                          _bits(ref[~dup]))
            np.testing.assert_allclose(got[dup], ref[dup], rtol=1e-6,
                                       atol=0)
