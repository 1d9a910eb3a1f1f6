"""encode_ms.grasp: the mean over the window's requests of the device
time (CUDA events, the stream's timeline) of the grasp.encode span."""


def read(record):
    ms = record.get("spans", {}).get("grasp.encode")
    return sum(ms) / len(ms) if ms else None
