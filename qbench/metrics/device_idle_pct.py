"""The share of the traced window in which no operation ran on the device,
in %: 1 - (union of the device's operations) / (the window's span)."""

from qbench.trace import busy_intervals, window


def read(record):
    w, busy = window(record), busy_intervals(record)
    if w is None or busy is None:
        return None
    return 100 * (1 - sum(e - s for s, e in busy) / (w[1] - w[0]))
