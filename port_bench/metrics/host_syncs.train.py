"""host_syncs.train: the synchronizing calls torch reported inside the
program's spans (the counter ``sync``) per step of the profiled block."""

from port_bench.harness.program import counter


def read(record):
    return counter(record, "train", "sync")
