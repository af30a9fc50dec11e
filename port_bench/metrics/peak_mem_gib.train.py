"""peak_mem_gib.train: ``torch.cuda.max_memory_reserved()`` over the
window of training steps, after ``reset_peak_memory_stats()``, in GiB: what
the card holds for the step, so 80 GB less it is what a larger batch could
use. Reserved and not allocated, because a replay's activations live in its
CUDA graph's private pool, which the allocated count leaves out."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["peak_mem_bytes"]:
        return None
    return ctx["peak_mem_bytes"] / 2**30
