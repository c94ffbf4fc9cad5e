"""The evaluation against the JAX package: the meter, the tie rule of the
top-k count, and the eval step.

* ``TopKClassMeter`` against JAX's on the same scores (no ties: its
  ``argpartition`` breaks ties arbitrarily in both packages).
* ``topk_hits`` against ``lax.top_k`` on logits with ties planted at the
  k-th place and on the label: equal hits, the lower class first.
* ``eval_step`` against ``build_eval_step`` on ResNet-20 at W=2, each
  worker with its own BatchNorm statistics, the classifier's columns of
  three classes made equal so the logits tie: equal counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.func import functional_call

from dgc_tpu.models import resnet20
from dgc_tpu.training import build_eval_step
from dgc_tpu.utils.meters import TopKClassMeter as JMeter
from dgc_tpu_torch.compression.flat import ParamLayout
from dgc_tpu_torch.interop import carry_variables
from dgc_tpu_torch.models import create, param_tree, stats_tree
from dgc_tpu_torch.parallel.comm import LocalComm
from dgc_tpu_torch.training.step import (FlatSetup, _binding, eval_step,
                                         topk_hits)
from dgc_tpu_torch.utils.meters import TopKClassMeter

W = 2


@pytest.mark.parametrize("k", [1, 5, 12])
def test_meter_matches_jax(k):
    rng = np.random.RandomState(k)
    jm, tm = JMeter(k), TopKClassMeter(k)
    for _ in range(3):
        out = rng.randn(40, 10).astype(np.float32)
        y = rng.randint(0, 10, 40)
        jm.update(out, y)
        tm.update(out, y)
    tm.update_counts(7, 9)
    jm.update_counts(7, 9)
    assert tm.data() == jm.data()
    assert tm.compute() == jm.compute()
    tm.set({"num_correct": 3, "num_examples": 4})
    assert tm.compute() == 75.0
    tm.reset()
    assert tm.compute() == 0.0 == TopKClassMeter(1).compute()


def _tied_logits(rng, n=64, classes=10):
    """Integer-valued logits: many ties, also at the k-th place and on
    the label."""
    logits = rng.randint(0, 4, (n, classes)).astype(np.float32)
    logits[:8] = 1.0                                  # all tied
    labels = rng.randint(0, classes, n)
    return logits, labels


@pytest.mark.parametrize("k", [1, 3, 5, 10, 11])
def test_topk_hits_follow_lax_top_k_ties(k):
    logits, labels = _tied_logits(np.random.RandomState(k))
    kk = min(k, logits.shape[1])
    _, pred = jax.lax.top_k(jnp.asarray(logits), kk)
    want = np.asarray(jnp.any(pred == labels[:, None], axis=-1))
    got = topk_hits(torch.from_numpy(logits), torch.from_numpy(labels), k)
    np.testing.assert_array_equal(got.numpy(), want)
    if k < 10:
        # the ties decide: some label ties the k-th place and misses
        kth = np.sort(logits, axis=1)[:, ::-1][:, kk - 1]
        at = logits[np.arange(len(labels)), labels] == kth
        assert (at & ~want).any() and (at & want).any()


@pytest.fixture(scope="module")
def tied_variables():
    v = jax.tree.map(np.array, jax.device_get(resnet20().init(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)), train=True)))
    dense = v["params"]["Dense_0"]
    # classes 1, 3 and 6 share a column, and lead every other class: the
    # tie rule decides the top-1 of their labels (class 1 wins)
    dense["bias"][1] += 100.0
    for j in (3, 6):
        dense["kernel"][:, j] = dense["kernel"][:, 1]
        dense["bias"][j] = dense["bias"][1]
    return v


def test_eval_step_matches_jax(tied_variables):
    v = tied_variables
    rng = np.random.RandomState(0)
    n = 24
    images = rng.randn(W * n, 32, 32, 3).astype(np.float32)
    labels = rng.choice([1, 3, 6, 0, 9], W * n).astype(np.int32)
    # each worker's own statistics
    stats = [jax.tree.map(lambda x, w=w: x * (1.0 + 0.1 * w) if x.ndim
                          else x, v["batch_stats"]) for w in range(W)]
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    eval_fn = build_eval_step(resnet20().apply, mesh, W)
    jstats = jax.tree.map(lambda *xs: jnp.stack(xs), *stats)
    want = eval_fn(v["params"], jstats, jnp.asarray(images),
                   jnp.asarray(labels))

    model = create("resnet20", 10, torch.Generator())
    setup = FlatSetup(ParamLayout(param_tree(model)),
                      ParamLayout(stats_tree(model)), None)
    flat_stats = []
    for s in stats:
        params, fs = carry_variables(v["params"], s, setup.layout,
                                     setup.stats_layout)
        flat_stats.append(fs)
    xs = [torch.from_numpy(images[w * n:(w + 1) * n]).permute(0, 3, 1, 2)
          for w in range(W)]
    ys = [torch.from_numpy(labels[w * n:(w + 1) * n]).long()
          for w in range(W)]
    got = eval_step(model, setup, params, flat_stats, xs, ys, LocalComm(W))
    assert {k: int(x) for k, x in got.items()} == {
        k: int(x) for k, x in want.items()}
    assert int(got["count"]) == W * n
    # the classifier's ties reach the logits
    binding = {**_binding(setup.layout, params),
               **_binding(setup.stats_layout, flat_stats[0])}
    with torch.no_grad():
        logits = functional_call(model, binding, (xs[0],), {"train": False})
    assert (logits[:, 1] == logits[:, 3]).all()
    assert (logits[:, 1] == logits[:, 6]).all()
    hit = int((labels == 1).sum())
    assert int(got["top1"]) == hit and 0 < hit < W * n
