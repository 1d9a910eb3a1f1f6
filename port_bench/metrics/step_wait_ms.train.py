"""step_wait_ms.train: the host ms blocked at the step's one read of
its scalars (the program's ``trainer.read`` span, Trainer._host) per step of
the profiled block: near 0, the host issued the step no sooner than the
card ran it."""

from port_bench.harness.program import span_ms


def read(record):
    return span_ms(record, "train", "trainer.read")
