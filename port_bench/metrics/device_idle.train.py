"""device_idle.train: the share of the traced window of training steps in
which no kernel, copy or set ran on the card, in %."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
