"""tactile_test's depth U-Net and sensor-pose head in bfloat16 against the
JAX package's bfloat16 evaluation, alone, on the CPU at small widths: the
checks and bars of tests/test_torch_fast_modules.py.
"""

import pytest

from test_torch_fast_modules import SPLIT, check_module, share_cores, synth  # noqa: F401


@pytest.mark.parametrize("name,mod", SPLIT["tactile"])
def test_bf16_module_matches_jax(synth, name, mod):
    check_module(synth, name, mod)
