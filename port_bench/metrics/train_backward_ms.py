"""train_backward_ms: the mean over the window's steps of the device time
from the trainer's ``decode`` mark to its ``backward`` mark (the backward
pass; Trainer.stage_events, CUDA events)."""


def read(record):
    ms = (record.get("stages") or {}).get("backward")
    if record.get("family") != "train" or not ms:
        return None
    return sum(ms) / len(ms)
