"""The FLOPs of a step, counted once from the configuration's reference at
the cell's shapes on meta tensors, so the count is the same whatever
implements the step.

``FlopCounterMode`` counts the convolutions, the matrix products and their
gradients. Each gradient of a convolution costs what its forward costs
(FlopCounterMode's own rule counts a grouped convolution's weight gradient
with every input channel against every output channel, ``groups`` times
the forward). Elementwise work, norms, resizes and the random draws count
nothing; nothing recomputed is counted, and the optimizers' updates are
left out.
"""

from __future__ import annotations

import torch


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **_):
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def counter():
    """A ``FlopCounterMode`` with :func:`_conv_backward_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def step_flops(config: dict, traffic: dict, device="meta") -> float:
    """FLOPs of one train step of ``config``'s reference under ``traffic``
    (its phase) at the configuration's batch and image size."""
    from benchmark.harness import sides

    ref = sides.reference_module(config)
    prog = config["program"]
    model, data = prog["model"], prog["data"]
    b, s = int(data["batch_size"]), int(data["image_size"])
    models = ref.build(model["backbone"], model["output_stride"], device)
    shapes = {"image_s": (b, s, s, 3), "map_s": (b, s, s, 2), "boundary_s": (b, s, s, 1),
              "image_t": (b, s, s, 3)}
    batch = {k: torch.zeros(v, dtype=torch.uint8, device=device) for k, v in shapes.items()}
    g = None if torch.device(device).type == "meta" else torch.Generator(device).manual_seed(0)
    with counter() as c:
        ref.train_step(models, (None, None, None), batch, 0, 0, g, prog["method"],
                       traffic["lr_gen"], traffic["lr_dis"], bool(traffic["proto_phase"]), {},
                       apply_updates=False)
    return float(c.get_total_flops())
