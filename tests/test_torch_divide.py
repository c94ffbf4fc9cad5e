"""The divide by W at a W that is not a power of two (W = 3).

``kernels.divide_exact`` is the port's one divide by W (the flat engine's
dense tail and apply, the per-tensor average, the dense compressors): an
IEEE divide by a 0-dim tensor on every device. PyTorch's CUDA divide by a
Python scalar multiplies by the reciprocal instead, which differs at
W = 3; the card's side of this is held in ``chip_smoke.py`` (card == CPU
at W = 3). Here, on the CPU:

* the helper against NumPy's IEEE divide and the JAX package's op-by-op
  divide (bitwise), and against the jitted JAX divide, which XLA may
  rewrite into a multiply (within one ulp);
* the flat engine's exchange at W = 3 (ResNet-20, epochs 0 and 5, two
  steps) against the JAX engine run op by op under ``jax.vmap``, as
  test_torch_engine.py runs it at W = 8: bitwise apart from coordinates
  several workers sent (rtol 1e-6, the reference's scatter order);
* the per-tensor exchange at W = 3 (ResNet-20, dense ratio 0.05 and the
  sampled ratio 0.001) against the JAX per-tensor exchange run op by op
  under ``jax.vmap``, as test_torch_per_tensor_exchange.py runs it at
  W = 8: memory bitwise, gradients bitwise apart from coordinates several
  workers sent (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_engine as engine_tests
import tests.test_torch_per_tensor_exchange as per_tensor_tests
from dgc_tpu_torch.ops import kernels as tk
from tests.test_torch_per_tensor_exchange import (  # noqa: F401
    one_torch_thread, variables)

W = 3


def test_divide_exact_is_ieee():
    x = np.random.RandomState(0).randn(100_000).astype(np.float32)
    got = tk.divide_exact(torch.from_numpy(x), W).numpy()
    ieee = x / np.float32(W)
    np.testing.assert_array_equal(got.view(np.int32), ieee.view(np.int32))
    op_by_op = np.asarray(jnp.asarray(x) / W)
    np.testing.assert_array_equal(got.view(np.int32), op_by_op.view(np.int32))
    # a multiply by the rounded reciprocal, as PyTorch's CUDA divide by a
    # Python scalar computes it, differs
    recip = x * np.float32(1.0 / W)
    assert (recip.view(np.int32) != ieee.view(np.int32)).any()
    jitted = np.asarray(jax.jit(lambda a: a / W)(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(jitted, ieee, maxulp=1)
    # other dtypes keep theirs; integers divide as PyTorch does
    b = tk.divide_exact(torch.from_numpy(x).bfloat16(), W)
    assert b.dtype == torch.bfloat16
    assert torch.equal(tk.divide_exact(torch.arange(6), W),
                       torch.arange(6) / W)


@pytest.mark.parametrize("epoch", [0, 5])
def test_flat_exchange_at_w3_matches_jax_engine(monkeypatch, variables,
                                                epoch):
    monkeypatch.setattr(engine_tests, "W", W)
    je, te = engine_tests._engines(variables["params"], epoch)
    engine_tests._check_steps(je, te, engine_tests._vmap_step(je), epoch,
                              steps=2)


@pytest.mark.parametrize("name", ["plain", "sampled"])
def test_per_tensor_exchange_at_w3_matches_jax(monkeypatch, variables,
                                               name):
    monkeypatch.setattr(per_tensor_tests, "W", W)
    per_tensor_tests.check_case(variables["params"], name)
