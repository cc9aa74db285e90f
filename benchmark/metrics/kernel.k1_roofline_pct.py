"""K1, the MC pass's fused mask head (the program's ``mask_head_kernel``):
its least time by bytes over its device time per step in the profiled
sub-window. Bytes (frozen formula): each of the M = T * B_t * (H/4) *
(W/4) rows reads its 305 channels once and writes 2, in the compute dtype;
at T 8, B_t 8, 512^2, bfloat16, M = 1,048,576 and 643.8 MB. Nothing is read
where the step runs no MC pass or K1 does not appear in the trace."""

from benchmark.harness import peaks

UNIT = "%"
KERNEL = "mask_head_kernel"


def k1_bytes(config: dict) -> int:
    prog = config["program"]
    b, s = int(prog["data"]["batch_size"]), int(prog["data"]["image_size"])
    t = int(prog["method"]["mc_samples"])
    itemsize = 2 if prog["model"]["compute_dtype"] == "bfloat16" else 4
    rows = t * b * (s // 4) * (s // 4)
    return rows * (305 + 2) * itemsize


def read(rec):
    bw = peaks.peak_bytes(rec.device_name)
    ns = sum(e - s for name, s, e in rec.kernels if KERNEL in name)
    if not rec.traffic.get("proto_phase") or not bw or not ns or not rec.trace_steps:
        return None
    least_s = k1_bytes(rec.config) / bw
    return 100.0 * least_s / (ns / 1e9 / rec.trace_steps)
