"""transfer_bytes.grasp: the bytes the program's logits copy moves to the
host (the counter ``decode.bytes``, generator._host) per request of the
profiled block."""

from port_bench.harness.program import counter


def read(record):
    return counter(record, "grasp", "decode.bytes")
