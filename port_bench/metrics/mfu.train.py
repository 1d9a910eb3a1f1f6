"""mfu.train: three times the model FLOPs of one forward step (the matrix
products and convolutions of the reference's forward on the first
checked batch, counted by torch's FlopCounterMode from their shapes) for
every step of the traced run, over the time those steps took, at the
TF32 tensor peak."""

from port_bench.harness.device import PEAK_FLOPS


def read(record):
    flops = record.get("forward_flops")
    busy_s = sum(record.get("step_ms", ())) / 1e3
    if record.get("family") != "train" or not flops or busy_s <= 0:
        return None
    return 100.0 * record["steps"] * 3 * flops / (busy_s * PEAK_FLOPS)
