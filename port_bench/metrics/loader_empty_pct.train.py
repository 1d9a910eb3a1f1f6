"""loader_empty_pct.train: of the batches the loader handed out in the
profiled block, the share the step's thread had to wait for (100 x the
counter ``loader.empty`` over ``loader.batches``, BatchLoader): near 100
when loading cannot keep up, one batch in an epoch when only each
epoch's restart waits."""

from port_bench.harness.program import counter


def read(record):
    batches = counter(record, "train", "loader.batches")
    if not batches:
        return None
    return 100.0 * counter(record, "train", "loader.empty") / batches
