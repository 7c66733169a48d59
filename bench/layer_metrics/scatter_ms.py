"""scatter_ms: ms a request in the engine's ``scatter`` span (RouteProgram.scatter: centers and labels back to the host and into per-request results).

The exact sum of the engine's ``span_seconds{span=scatter}`` histogram
over the traced window, divided by the requests it completed."""


def read(ctx):
    return ctx.span_ms_per_request("scatter")
