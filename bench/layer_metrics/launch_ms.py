"""launch_ms: ms a request in the engine's ``launch`` span (RouteProgram.launch, fenced: the bucket's device work, from the first launch to the fence).

The exact sum of the engine's ``span_seconds{span=launch}`` histogram
over the traced window, divided by the requests it completed."""


def read(ctx):
    return ctx.span_ms_per_request("launch")
