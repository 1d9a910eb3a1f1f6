"""host_syncs.grasp: the synchronizing calls torch reported inside the
program's spans (the counter ``sync``) per request of the profiled block."""

from port_bench.harness.program import counter


def read(record):
    return counter(record, "grasp", "sync")
