"""The device's idle share: the share of the traced sub-window of device
activity alone (from its first device operation to its last, over whole
steps) in which no operation runs on the card, the union of the device
intervals taken as busy. That sub-window records no host activity, which
slows the host's launches least; standard error gives beside it the share
the untraced window's steps would leave at the same busy time."""

UNIT = "%"


def read(rec):
    if not rec.trace_steps or rec.trace_hi <= rec.trace_lo or not rec.kernels:
        return None
    from benchmark.harness import stats

    return 100.0 * stats.idle_share([(k[1], k[2]) for k in rec.kernels], rec.trace_lo,
                                    rec.trace_hi)
