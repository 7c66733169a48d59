"""gather_ms: ms a request in the engine's ``gather`` span (RouteProgram.gather: stacking and padding a bucket's lanes and staging them on the card).

The exact sum of the engine's ``span_seconds{span=gather}`` histogram
over the traced window, divided by the requests it completed."""


def read(ctx):
    return ctx.span_ms_per_request("gather")
