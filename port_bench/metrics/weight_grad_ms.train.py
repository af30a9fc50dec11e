"""weight_grad_ms.train: the device time, in ms, of the kernels launched
inside the program's ``svrs.step.weight_grad`` spans (each conv's weight
gradient, one library call, on autograd's thread), per eager step
(``svrs.step``). A replayed step has no such span: nothing to read."""

from port_bench.harness import spans


def read(ctx):
    if ctx["kind"] != "train" or "spans" not in ctx:
        return None
    seconds = ctx["device_by_span"]["total"].get("svrs.step.weight_grad", 0.0)
    steps = spans.count(ctx, "svrs.step")
    if seconds <= 0 or not steps:
        return None
    return 1e3 * seconds / steps
