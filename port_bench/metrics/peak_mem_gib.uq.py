"""peak_mem_gib.uq: ``torch.cuda.max_memory_reserved()`` over the window of
requests, after ``reset_peak_memory_stats()``, in GiB: what the card holds
for a request, so 80 GB less it is what a larger draw chunk
(``tasks.auto_chunk``) could use."""


def read(ctx):
    if ctx["kind"] != "uq" or not ctx["peak_mem_bytes"]:
        return None
    return ctx["peak_mem_bytes"] / 2**30
