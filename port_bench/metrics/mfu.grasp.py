"""mfu.grasp: the model FLOPs of every request of the traced run (the
matrix products and convolutions of the reference's encoder, gates and
whole-grid decode for one grasp, counted by torch's FlopCounterMode from
their shapes) over the time those requests were in flight, at the TF32
tensor peak."""

from port_bench.harness.device import PEAK_FLOPS


def read(record):
    flops = record.get("flops_per_request")
    busy_s = sum(record.get("latency_ms", ())) / 1e3
    if record.get("family") != "grasp" or not flops or busy_s <= 0:
        return None
    return 100.0 * record["completed"] * flops / (busy_s * PEAK_FLOPS)
