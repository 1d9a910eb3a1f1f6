"""upload_ms.train: the host ms of the program's ``trainer.upload``
span (Trainer.prepare_batch: the batch's arrays to the card) per step of the
profiled block."""

from port_bench.harness.program import span_ms


def read(record):
    return span_ms(record, "train", "trainer.upload")
