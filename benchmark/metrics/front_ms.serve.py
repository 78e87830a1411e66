"""Serving: the median over the traced window's scenes of the host's time
to dispatch one (the program's ``serve.dispatch`` span: padding, the copy
into page-locked memory, the upload's enqueue and the runner's launches),
ms.  None where the program records no such span.  Layer: serving
front."""

import statistics

from benchmark.harness import program_spans


def read(ctx):
    spans = program_spans.named(program_spans.record(), ("serve.dispatch",))
    if not spans:
        return None
    return statistics.median(s.end_ns - s.start_ns for s in spans) / 1e6
