"""Step dispatch: the mean milliseconds per step the host spent inside the
step's call (the benchmark's clock around it) over the window. The step
never waits for the card, so this is the host's time to enqueue it, unless
the launch queue is full."""

UNIT = "ms"


def read(rec):
    return sum(rec.dispatch_ms) / len(rec.dispatch_ms) if rec.dispatch_ms else None
