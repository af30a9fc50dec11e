"""prior_ms.uq: the mean wall time, in ms, of the conditioning pass of a
request (the program's ``svrs.uq.prior`` span: ``encode_y``, the u draw,
``y_embedding``, ``z_cond``) over the window's requests (``svrs.uq.request``):
the B=1 part of a request that the 1000 draws do not amortise."""

from port_bench.harness import spans


def read(ctx):
    if ctx["kind"] != "uq" or "spans" not in ctx:
        return None
    priors, requests = spans.durations(ctx, "svrs.uq.prior"), spans.count(ctx, "svrs.uq.request")
    if not priors or not requests:
        return None
    return sum(priors) / requests / 1e3
