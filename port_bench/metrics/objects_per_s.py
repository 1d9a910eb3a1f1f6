"""objects_per_s: every mesh completed in the window over the window's
whole length (it ends when the last request does)."""


def read(record):
    if record.get("family") not in ("grasp", "split") or record["window_s"] <= 0:
        return None
    return record["completed"] / record["window_s"]
