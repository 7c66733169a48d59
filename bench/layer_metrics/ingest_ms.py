"""ingest_ms: ms a request in the engine's ``ingest`` span (serving/fcm_engine.py submit -> _ingest: validating and reducing each image of a request (a copy of its pixels)).

The exact sum of the engine's ``span_seconds{span=ingest}`` histogram
over the traced window, divided by the requests it completed."""


def read(ctx):
    return ctx.span_ms_per_request("ingest")
