"""device.idle_share: 1 - (union of the card's operations) / (the traced
window's own start-to-stop span), in percent; the window's edges count,
unlike a first-to-last-kernel span. Moves steps_per_s."""


def read(counters, trace):
    if trace is None or not trace.ops or "train_op" not in counters:
        return None
    return 100.0 * trace.idle_share()
