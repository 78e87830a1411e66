"""Training: percent of the traced window in which the card was idle while
the host waited on the training feed (under the program's ``loader.next``,
``loader.slot`` and ``loader.upload`` spans).  Idle time is taken between
the window's device operations, so the edges before the first and after
the last (under one step) are left out.  None where the program records
no such span.  Layer: training loop and host data pipeline."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_share_under(ctx, program_spans.named(
        program_spans.record(), program_spans.FEED))
