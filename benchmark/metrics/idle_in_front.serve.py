"""Serving: percent of the traced window in which the card was idle while
the host dispatched a scene (under the program's ``serve.dispatch``
spans).  Idle time is taken between the window's device operations, so
the edges before the first and after the last (under one scene) are left
out.  None where the program records no such span.  Layer: serving
front."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_share_under(ctx, program_spans.named(
        program_spans.record(), ("serve.dispatch",)))
