"""The control of each cell, on the card: the plain reference in the
program's place one precision below the configuration's (TF32 for the
grasp cells, bfloat16 for training), at tiny widths, comes out as not
correct.
(At the cells' own sizes: ``python3 port_bench/control.py``.)"""

import pytest

from port_bench import control
from port_bench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config", (("vtaco_ycb.grasp", "vtaco_ycb"),
                                         ("vtacoh_ycb.grasp", "vtacoh_ycb"),
                                         ("vtacoh_ycb.train_b6", "vtacoh_ycb")))
def test_control_is_not_correct(cuda, cell, config):
    conf = tiny.config(config)
    m = conf["config"]["model"]
    # TF32 rounds at widths of 32 and up; the tiny decoder and encoder are
    # widened back to the published 32 so that the control's products run
    # on the tensor cores
    m["c_dim"] = m["decoder_kwargs"]["hidden_size"] = m["encoder_img_kwargs"]["num_classes"] = 32
    m["encoder_kwargs"].update(hidden_dim=32)
    m["encoder_kwargs"]["unet3d_kwargs"].update(f_maps=32, in_channels=32, out_channels=32)
    mix = tiny.benchmark_cell(cell)["traffic"]
    out = control.control(tiny.benchmark(), cell, 2 ** 34 + 3, device=cuda, config=conf,
                          traffic=tiny.traffic(mix))
    assert not out["correct"], out["checks"]
