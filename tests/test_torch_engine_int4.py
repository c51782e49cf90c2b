"""The int4 case of the port's engine against JAX's on the trained
struct_tiny8 pair (tests/test_torch_engine.py's module docstring says why
the JAX engine runs its Pallas kernels in interpret mode), in a file of its
own so that `--dist loadfile` runs it beside the other cases."""

import pytest

from tests.torch_engine_util import (  # noqa: F401 (fixtures)
    N_NEW, _struct_pair, jax_4bit_through_pallas, one_torch_thread,
)


@pytest.mark.parametrize("kind", ["int4"])
def test_port_generate_matches_jax_token_for_token_4bit(
        kind, jax_4bit_through_pallas):
    jeng, port, prompt = _struct_pair(kind)
    want, wstats = jeng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    got, gstats = port.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    assert [int(t) for t in want] == got
    assert gstats["rounds"] == wstats["rounds"]
    assert gstats["accept_per_round"] == wstats["accept_per_round"] > 1.5
