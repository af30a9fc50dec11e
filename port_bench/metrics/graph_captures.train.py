"""graph_captures.train: the CUDA graph captures the program's trainer made
inside the window (``Trainer.graph_captures`` after the window less
before): 0 where every replay found its graph; a capture in the window is
a recompile the rate pays for."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx.get("graph_captures")
