"""The bfloat16 step of tactile_test_fast in the PyTorch port against the
JAX package, on the CPU at small widths: the checks of
tests/test_torch_fast_bf16.py.
"""

import pytest

from test_torch_fast import share_cores, synth  # noqa: F401
from test_torch_fast_bf16 import check_bf16_step, check_f32_state


@pytest.mark.parametrize("name", ["tactile"])
def test_bf16_step_matches_jax(synth, name):
    check_bf16_step(synth, name)


@pytest.mark.parametrize("name", ["tactile"])
def test_bf16_training_keeps_f32_state(synth, name):
    check_f32_state(synth, name)
