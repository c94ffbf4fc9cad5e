"""The port's per-tensor exchange against the JAX package's with the bf16
memory, with sampled thresholds (ratio 0.001, ``sample_ratio=0.01``, the
JAX-drawn strided phases passed in), and jitted under ``shard_map`` on
the 8-device mesh; the cases and their tolerances are
test_torch_per_tensor_exchange.py's."""

import pytest

from tests.test_torch_per_tensor_exchange import (  # noqa: F401
    CASES, _run, check_case, one_torch_thread, variables)


@pytest.mark.parametrize("name", ["bf16_memory", "sampled"])
def test_exchange_state_and_sampling_match_jax(variables, name):  # noqa: F811
    check_case(variables["params"], name)


def test_exchange_matches_jax_on_mesh8(mesh8, variables):  # noqa: F811
    _run(variables["params"], CASES["plain"], steps=2, mesh=mesh8)
