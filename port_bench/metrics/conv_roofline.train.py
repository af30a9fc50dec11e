"""conv_roofline.train: the roofline-bound time of the conv kernels' work
in the traced steps (forward and input gradient of every conv; each input
byte read once, each output byte written once) over the device time of the
port's conv kernels by name in the trace, in %."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"] or ctx["conv_device_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["conv_bound_s"] * ctx["units"] / ctx["conv_device_s"]
