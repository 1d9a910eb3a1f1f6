"""Each ``*_fast`` config through the train CLI in the PyTorch port, on
the CPU at small widths: VTacOH_YCB_fast and tactile_test_fast here,
VTacO_YCB_fast in tests/test_torch_fast_cli_vtaco.py (the fused loop's
cadences and resume are in tests/test_torch_fast_loop.py).
"""

import numpy as np
import pytest
import torch
import yaml

from vtaco_tpu_torch.core.checkpoint import CheckpointIO

from test_trainer import _small_cfg
from test_torch_fast import FAST, share_cores, synth  # noqa: F401
from test_torch_fast_loop import _loss_its


def check_cli(synth, tmp_path, capsys, name):
    """python -m vtaco_tpu_torch.cli.train on each *_fast config (at small
    widths, --cpu): 2K + 3 = 19 steps at its 8 steps per block, so that
    blocks of 8 and of 1 run, fused validation, a checkpoint, the resident
    split's size printed, and every parameter float32 in the
    checkpoint."""
    from vtaco_tpu_torch.cli.train import main

    cfg = _small_cfg(FAST[name], *synth)
    out = tmp_path / "out"
    cfg["training"].update(out_dir=str(out), batch_size=2, validate_every=19,
                           checkpoint_every=19, backup_every=0, visualize_every=0,
                           print_every=1, n_workers=1, n_workers_val=1)
    if name == "vtaco":   # no pretrained stack here: the graft warns and goes on
        cfg["model"]["encoder_t2d_kwargs"]["model_file"] = str(tmp_path / "none.ckpt")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main([str(path), "--max-iters", "19", "--cpu"])
    text = capsys.readouterr().out
    assert "device-resident dataset: 4 models" in text and "Validation metric" in text
    its, recs = _loss_its(str(out))
    assert its == list(range(1, 20))
    # iou_fixed is NaN (0/0) when neither labels nor logits reach the
    # threshold, in both packages (ROADMAP.md §3)
    assert all(np.isfinite(r["value"]) for r in recs if r["tag"] != "val/iou_fixed")
    payload, scalars = CheckpointIO(str(out)).load_raw("model.ckpt")
    assert scalars["it"] == 19
    assert all(v.dtype == torch.float32 for v in payload["model"].values()
               if v.is_floating_point())


@pytest.mark.parametrize("name", ["vtacoh", "tactile"])
def test_fast_config_trains_through_cli(synth, tmp_path, capsys, name):
    check_cli(synth, tmp_path, capsys, name)
