"""The backbone's host enqueue: milliseconds a step of host time inside the
program's ``clr.backbone`` spans (``uda_clr_tpu_torch/utils/tracing.py``;
every backbone call of the step, the teacher's and the S || T forward's),
over the steps of the profiled sub-window of device activity alone. Nothing
is read where the program records no such span."""

UNIT = "ms"
SPAN = "clr.backbone"


def read(rec):
    if not rec.trace_steps or not rec.span_lo:
        return None
    try:
        from uda_clr_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = tracing.summary(tracing.steps(before_ns=rec.span_lo, last=rec.trace_steps)).get(SPAN)
    return ms or None
