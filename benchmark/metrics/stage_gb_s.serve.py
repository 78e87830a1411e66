"""Serving: the host's copy bandwidth into page-locked memory, GB/s: the
bytes of the program's ``serve.stage`` spans (each date's copy into the
pinned buffer the upload reads) over their summed durations, in the traced
window.  None where the program records no such span.  Layer: serving
front."""

from benchmark.harness import program_spans


def read(ctx):
    spans = program_spans.named(program_spans.record(), ("serve.stage",))
    seconds = program_spans.seconds(spans)
    if seconds <= 0:
        return None
    return sum(s.fields["bytes"] for s in spans) / seconds / 1e9
