"""conv_roofline.uq: the roofline-bound time of the requests' convs (the
conditioning pass and the decoder over every draw) over the device time of
the port's conv kernels by name in the trace, in %."""


def read(ctx):
    if ctx["kind"] != "uq" or not ctx["units"] or ctx["conv_device_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["conv_bound_s"] * ctx["units"] / ctx["conv_device_s"]
