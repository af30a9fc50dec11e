"""mfu.uq: the requests' model operations (the conditioning pass and the
decoder over every draw, forward only) over the traced window's time and
the peak of the dtype's conv units, in %."""

from port_bench.harness import work


def read(ctx):
    if ctx["kind"] != "uq" or not ctx["units"]:
        return None
    rate = ctx["work"]["model_flops"] * ctx["units"] / ctx["window_s"]
    return 100.0 * rate / work.peak_flops(ctx["dtype"])
