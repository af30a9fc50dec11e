"""program_idle.uq: the share of the traced window, in %, in which the card
is idle while the main thread is inside a request of the program
(``svrs.uq.request`` and the spans it encloses): the part of
``device_idle.uq`` that the program's own request path holds, where the
rest is the benchmark loop's."""


def read(ctx):
    if ctx["kind"] != "uq" or "idle_by_span" not in ctx or ctx["window_s"] <= 0:
        return None
    idle = ctx["idle_by_span"]["total"].get("svrs.uq.request")
    return None if idle is None else 100.0 * idle / ctx["window_s"]
