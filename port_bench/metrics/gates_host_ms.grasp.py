"""gates_host_ms.grasp: the host ms of the program's ``gates`` span
(Generator3D._build_gates) per request of the profiled block, beside the
device time of the benchmark's own span around the same call
(``gates_ms.grasp``)."""

from port_bench.harness.program import span_ms


def read(record):
    return span_ms(record, "grasp", "gates")
