"""The share of the traced window in which no operation ran on the
device: 1 - the union of the device operations' intervals / the window."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device_ops or tr.window_s() <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s()
