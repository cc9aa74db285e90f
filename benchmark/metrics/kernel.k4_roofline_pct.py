"""K4, the norm kernel (the program's ``domain_norm_*`` kernels): its least
time by bytes over its device time a step in the profiled sub-window, at
the card's HBM peak.

Bytes (:func:`k4_bytes`), counted once on the configuration's reference at
the cell's shapes on meta tensors, so the count is the same whatever
implements the norm: each norm site the generator's train-mode forward
meets (a forward hook on the reference's norm module) is charged per
element, in the compute dtype, one read for the moments, a read and a
write for the normalize, two reads for the backward's reduce and two reads
and a write for dx (bf16: 2, 4, 4 and 6 B); a prototype-phase step's MC
suffix adds, on its T / 2 copies of the S || T batch's sizes, the moments
and normalize of the boundary head's two norms and the moments of the mask
head's 305 channels (its normalize is K1's). Nothing is read where no K4
kernel is in the trace."""

from benchmark.harness import peaks

UNIT = "%"
KERNEL = "domain_norm_"
FORWARD, BACKWARD = (1, 2), (2, 3)  # element passes: moments, normalize; reduce, dx


def k4_bytes(config: dict, traffic: dict) -> int:
    import torch

    from benchmark.harness import sides

    ref = sides.reference_module(config)
    prog = config["program"]
    model, method = prog["model"], prog["method"]
    b, s = int(prog["data"]["batch_size"]), int(prog["data"]["image_size"])
    itemsize = 2 if model["compute_dtype"] == "bfloat16" else 4
    models = ref.build(model["backbone"], model["output_stride"], "meta")
    sites = {}  # module -> elements of its input at each call

    def hook(module, args, _out):
        sites.setdefault(module, []).append(args[0].numel())

    gen = models.gen
    handles = [m.register_forward_hook(hook) for m in gen.modules()
               if isinstance(m, ref.BatchNorm)]
    batch = {k: torch.zeros(v, dtype=torch.uint8, device="meta") for k, v in {
        "image_s": (b, s, s, 3), "map_s": (b, s, s, 2), "boundary_s": (b, s, s, 1),
        "image_t": (b, s, s, 3)}.items()}
    proto = bool(traffic["proto_phase"])
    try:
        ref.train_step(models, (None, None, None), batch, 0, 0, None, method,
                       traffic["lr_gen"], traffic["lr_dis"], proto, {}, apply_updates=False)
    finally:
        for h in handles:
            h.remove()
    elements = sum(n for calls in sites.values() for n in calls)
    total = elements * sum(FORWARD + BACKWARD)
    if proto and method.get("retrify_pseudo", True):
        dec = gen.decoder
        boundary = sum(sites[dec.last_conv_boundary[i]][0] for i in (1, 5))
        half_t = int(method["mc_samples"]) // 2
        total += half_t * (boundary * sum(FORWARD) + sites[dec.last_conv[0]][0] * FORWARD[0])
    return total * itemsize


def read(rec):
    bw = peaks.peak_bytes(rec.device_name)
    ns = sum(e - s for name, s, e in rec.kernels if KERNEL in name)
    if not bw or not ns or not rec.trace_steps:
        return None
    least_s = k4_bytes(rec.config, rec.traffic) / bw
    return 100.0 * least_s / (ns / 1e9 / rec.trace_steps)
