"""decode_device_ms.uq: the device time, in ms, of the kernels launched
inside the program's ``svrs.uq.decode`` spans (the noise and the decoder
over the draws), per request: the card's share of the N-draw decode."""

from port_bench.harness import spans


def read(ctx):
    if ctx["kind"] != "uq" or "spans" not in ctx:
        return None
    seconds = ctx["device_by_span"]["total"].get("svrs.uq.decode", 0.0)
    requests = spans.count(ctx, "svrs.uq.request")
    if seconds <= 0 or not requests:
        return None
    return 1e3 * seconds / requests
