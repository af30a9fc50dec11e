"""mfu.train: the training steps' model operations over the traced
window's time and the peak of the dtype's conv units (bf16 989 TFLOP/s,
float32 as 3xTF32 495/3), in %. The operations are forward, input gradient
and weight gradient of every conv, counted once from the configuration's
shapes (``harness/work.py``)."""

from port_bench.harness import work


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    rate = ctx["work"]["model_flops"] * ctx["units"] / ctx["window_s"]
    return 100.0 * rate / work.peak_flops(ctx["dtype"])
