"""VTacO_YCB_fast's bfloat16 step at trained weights against the JAX
package's faithfully rounded step, on the CPU at small widths: the check
and bars of tests/test_torch_fast_trained.py (VTacOH and the tactile
stack), in a file of its own so that no file holds one worker long.
"""

import pytest

from test_torch_fast_trained import check_trained_step, share_cores, synth  # noqa: F401


@pytest.mark.parametrize("name", ["vtaco"])
def test_bf16_step_at_trained_weights(synth, name):
    check_trained_step(synth, name)
