"""Training: the host's time a step in the training feed, ms: the
program's ``loader.next`` (the wait for a worker's batch), ``loader.slot``
(the wait for a ring slot's copy to the card) and ``loader.upload`` (the
batch's copy enqueued) spans of the traced window, over its steps.  None
where the program records no such span.  Layer: training loop and host
data pipeline."""

from benchmark.harness import program_spans


def read(ctx):
    spans = program_spans.named(program_spans.record(), program_spans.FEED)
    steps = ctx["counts"].get("steps", 0)
    if not spans or not steps:
        return None
    return 1e3 * program_spans.seconds(spans) / steps
