"""Share of the traced window in which no kernel or copy ran on the
device (%)."""


def read(view):
    if view.window_s <= 0 or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
