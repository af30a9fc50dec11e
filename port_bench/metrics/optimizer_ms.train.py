"""optimizer_ms.train: the device time, in ms, of the kernels launched
inside the program's ``svrs.step.clip`` and ``svrs.step.adam`` spans (the
global-norm clip, then Adam and the parameter update), per eager step
(``svrs.step``). A replayed step has no such span: nothing to read."""

from port_bench.harness import spans


def read(ctx):
    if ctx["kind"] != "train" or "spans" not in ctx:
        return None
    total = ctx["device_by_span"]["total"]
    seconds = total.get("svrs.step.clip", 0.0) + total.get("svrs.step.adam", 0.0)
    steps = spans.count(ctx, "svrs.step")
    if seconds <= 0 or not steps:
        return None
    return 1e3 * seconds / steps
