"""conv_host_us.uq: the mean wall time, in microseconds, of one conv call
(the program's ``svrs.conv`` span: the casts, BatchNorm's fold and the
launch) inside the window's requests: the host's cost of a conv, which
paces a request where the card waits on it."""

from port_bench.harness import spans


def read(ctx):
    if ctx["kind"] != "uq" or "spans" not in ctx:
        return None
    convs = spans.durations(ctx, "svrs.conv", root="svrs.uq.request")
    return sum(convs) / len(convs) if convs else None
