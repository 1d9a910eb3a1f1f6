"""loader_wait_ms.train: the host ms the step's thread waited on the
loader's queue (the program's ``loader.wait`` spans, BatchLoader) per step of
the profiled block."""

from port_bench.harness.program import span_ms


def read(record):
    return span_ms(record, "train", "loader.wait")
