"""decode_wait_ms.grasp: the host ms blocked in the program's
``decode.copy`` span (the logits' copy to the host, generator._host) per
request of the profiled block."""

from port_bench.harness.program import span_ms


def read(record):
    return span_ms(record, "grasp", "decode.copy")
