"""The loop's wait on the loaders: the mean milliseconds a step the host
spent pulling the next batch pair (the benchmark's clock around each pull),
over the window's untraced steps."""

UNIT = "ms"


def read(rec):
    return sum(rec.wait_ms) / len(rec.wait_ms) if rec.wait_ms else None
