"""The port's per-tensor exchange against the JAX package's on the int8
and fp16 wires (crossed with nesterov and momentum masking); the cases
and their tolerances are test_torch_per_tensor_exchange.py's."""

import pytest

from tests.test_torch_per_tensor_exchange import (  # noqa: F401
    check_case, one_torch_thread, variables)


@pytest.mark.parametrize("name", ["no_masking_int8",
                                  "nesterov_no_masking_fp16"])
def test_exchange_wires_match_jax(variables, name):  # noqa: F811
    check_case(variables["params"], name)
