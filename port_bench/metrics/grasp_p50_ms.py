"""grasp_p50_ms: the median of the latency of the window's requests, from the
hand-over of a request's host arrays to its mesh on the host (numpy's
linear interpolation), leaving out the requests a traced run profiles."""

import numpy as np


def read(record):
    ms = record.get("unprofiled_ms")
    if record.get("family") != "grasp" or not ms:
        return None
    return float(np.percentile(ms, 50))
