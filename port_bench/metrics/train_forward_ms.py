"""train_forward_ms: the mean over the window's steps of the device time
from the trainer's ``start`` mark to its ``decode`` mark (the encoders,
the fingertip sample and the decode; Trainer.stage_events, CUDA
events)."""


def read(record):
    st = record.get("stages") or {}
    parts = [st.get(k) for k in ("encoders", "contact_labels", "decode")]
    if record.get("family") != "train" or not all(parts):
        return None
    n = min(len(p) for p in parts)
    return sum(sum(p[:n]) for p in parts) / n
