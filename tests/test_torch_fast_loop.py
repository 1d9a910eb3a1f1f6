"""The fused training loop in the PyTorch port on the CPU at small
widths: its cadences with the split on the device and K steps per block,
one step per call, and a resume (tests/test_torch_fast.py states the
tolerances; each ``*_fast`` config through the train CLI is in
tests/test_torch_fast_cli.py).
"""

import json
import os

from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_fast import share_cores, small, synth  # noqa: F401


def _loss_its(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["it"] for r in recs if r["tag"] == "train/loss"], recs


def test_fused_loop_end_to_end(synth, tmp_path, monkeypatch):
    """tests/test_device_data.py's test_fused_loop_end_to_end: train() with
    the split on the device and 4 steps per block, validation every 4,
    a checkpoint every 5, 7 steps: blocks of 4, 1, 1 and 1 steps, so that
    every cadence fires at its iteration; fused validation at 4 picks a
    best model; each iteration is logged once."""
    cfg = small("vtaco", synth)
    cfg["data"]["on_device"] = True
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, steps_per_dispatch=4,
                           validate_every=4, visualize_every=0, checkpoint_every=5,
                           backup_every=0, print_every=2)
    blocks = []
    make = Trainer.make_fused_train_fn

    def spy(self, *a, **kw):
        fn = make(self, *a, **kw)

        def run(ids, *r, **k):
            blocks.append(len(ids))
            return fn(ids, *r, **k)
        return run

    monkeypatch.setattr(Trainer, "make_fused_train_fn", spy)
    trainer, it = loop.train(cfg, max_iters=7, device="cpu")
    assert it == 7 and trainer.step == 7 and blocks == [4, 1, 1, 1]
    for f in ("model.ckpt", "model_best.ckpt"):
        assert os.path.exists(tmp_path / f)
    its, recs = _loss_its(str(tmp_path))
    assert its == list(range(1, 8))
    assert [r["it"] for r in recs if r["tag"] == "val/iou"] == [4]
    assert CheckpointIO(str(tmp_path)).load_raw("model_best.ckpt")[1]["it"] == 4


def test_on_device_loop_one_step_per_call(synth, tmp_path, monkeypatch):
    """data.on_device with one step per call (steps_per_dispatch 1): the
    loop takes the resident split's batches one by one through
    train_step, as the JAX loop does, and still validates through
    evaluate_device."""
    cfg = small("vtacoh", synth)
    cfg["data"]["on_device"] = True
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, steps_per_dispatch=1,
                           validate_every=2, checkpoint_every=0, backup_every=0,
                           visualize_every=0, print_every=1)
    calls = []
    monkeypatch.setattr(Trainer, "make_fused_train_fn", lambda *a, **k: calls.append(a))
    evaluate_device = Trainer.evaluate_device
    monkeypatch.setattr(Trainer, "evaluate_device",
                        lambda self, *a: calls.append("eval") or evaluate_device(self, *a))
    trainer, it = loop.train(cfg, max_iters=3, device="cpu")
    assert it == 3 and trainer.step == 3 and calls == ["eval"]
    its, recs = _loss_its(str(tmp_path))
    assert its == [1, 2, 3] and [r["it"] for r in recs if r["tag"] == "val/iou"] == [2]


def test_fused_dispatch_resumes(synth, tmp_path, capsys):
    """tests/test_resume.py's test_fused_dispatch_resumes: a fused run
    stopped at 4 resumes at the saved iteration and logs 1..8 once."""
    cfg = small("vtaco", synth)
    cfg["data"]["on_device"] = True
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, steps_per_dispatch=2,
                           validate_every=4, checkpoint_every=4, backup_every=0,
                           visualize_every=0, print_every=1)
    _, it1 = loop.train(cfg, max_iters=4, device="cpu")
    assert it1 == 4 and CheckpointIO(str(tmp_path)).load_raw("model.ckpt")[1]["it"] == 4
    capsys.readouterr()
    trainer, it2 = loop.train(cfg, max_iters=8, device="cpu")
    assert "resumed at it=4" in capsys.readouterr().out
    assert it2 == 8 and trainer.step == 8
    assert sorted(_loss_its(str(tmp_path))[0]) == list(range(1, 9))

