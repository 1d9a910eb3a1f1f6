"""VTacO_YCB_fast through the train CLI in the PyTorch port, on the CPU at
small widths: the check of tests/test_torch_fast_cli.py, in a file of its
own so that no file holds one worker long.
"""

import pytest

from test_torch_fast import share_cores, synth  # noqa: F401
from test_torch_fast_cli import check_cli


@pytest.mark.parametrize("name", ["vtaco"])
def test_fast_config_trains_through_cli(synth, tmp_path, capsys, name):
    check_cli(synth, tmp_path, capsys, name)
