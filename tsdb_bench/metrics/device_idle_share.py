"""device_idle_share: the share of the traced window in which no
operation ran on the card, 100 x (1 - the union of the device's busy
intervals / the window), in %."""


def read(run):
    tr = run.device
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
