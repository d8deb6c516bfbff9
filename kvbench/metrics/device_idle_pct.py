"""Layer ``device`` (one H100): the share of the traced window in which no
operation ran on the card, ``1 - union of the device operations' intervals
/ the window``, in %."""

from kvbench.profile import union_ns


def read(win):
    if not win.device_ops or win.window_s <= 0:
        return None
    busy_s = union_ns([(s, e) for _, s, e, _ in win.device_ops]) / 1e9
    return 100.0 * (1.0 - busy_s / win.window_s)
