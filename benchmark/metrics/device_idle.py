"""The share of the traced frames' host time in which no operation ran
on the card, in %: 1 - (the union of the device intervals) / (the
frames' wall time)."""


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
