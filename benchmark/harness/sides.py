"""The two sides of a training cell: the program under test
(``uda_clr_tpu_torch``, driven through the entry the Trainer calls) and the
plain reference a configuration names (``benchmark/reference/<name>.py``),
each started from the same weights (:func:`inputs.init_weights`).
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from benchmark.harness import check, inputs


class Program:
    """The port's train state and step for a configuration and a traffic
    mix: ``make_train_step(cfg, method, proto_phase=...)`` called as the
    Trainer calls it, ``step(state, batch, lr_gen, lr_dis, epoch)``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from uda_clr_tpu_torch.config import Config
        from uda_clr_tpu_torch.train.state import create_train_state
        from uda_clr_tpu_torch.train.steps import make_train_step

        self.cfg = Config.from_dict(config["program"])
        method = self.cfg.method.method
        self.state = create_train_state(self.cfg, seed=seed, device=device, method=method)
        self.proto_phase = bool(traffic["proto_phase"])
        self.step_fn = make_train_step(self.cfg, method, proto_phase=self.proto_phase)
        self.args = (traffic["lr_gen"], traffic["lr_dis"], traffic["epoch"])
        weights = inputs.init_weights(self.modules(), seed, device)
        for name, module in self.modules().items():
            module.load_state_dict(weights[name])

    def modules(self) -> dict:
        st = self.state
        return {k: v for k, v in (("gen", st.gen), ("dis", st.dis), ("dis2", st.dis2))
                if v is not None}

    def optimizers(self) -> dict:
        st = self.state
        return {k: v for k, v in (("gen", st.gen_opt), ("dis", st.dis_opt),
                                  ("dis2", st.dis2_opt)) if v is not None}

    def banks(self) -> dict:
        if not self.proto_phase:
            return {}
        return {"src": self.state.proto_src, "trg": self.state.proto_trg}

    def recorder(self) -> check.Recorder:
        return check.Recorder(self.modules(), self.optimizers(), self.banks)

    def step(self, batch: dict) -> dict:
        self.state, metrics = self.step_fn(self.state, batch, *self.args)
        return metrics


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (TF32 off), restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def reference_readings(config: dict, traffic: dict, seed: int, device, batches,
                       quant=None) -> dict:
    """The reference's readings over its first :data:`check.STEPS` steps on
    ``batches`` (the batches the program's first steps took), in float32
    with TF32 off, or through ``quant`` (the lower-precision control)."""
    ref = reference_module(config)
    model, method, optim = (config["program"][k] for k in ("model", "method", "optim"))
    with no_tf32():
        models = ref.build(model["backbone"], model["output_stride"], device, quant)
        named = {"gen": models.gen, "dis": models.dis, "dis2": models.dis2}
        weights = inputs.init_weights(named, seed, device)
        for name, module in named.items():
            module.load_state_dict(weights[name])
        del weights
        opts = ref.optimizers(models, optim)
        banks: dict = {}
        rec = check.Recorder(named, dict(zip(("gen", "dis", "dis2"), opts)),
                             lambda: dict(banks))
        g = torch.Generator(device).manual_seed(seed)
        proto = bool(traffic["proto_phase"])
        for i in range(check.STEPS):
            losses = ref.train_step(models, opts, batches[i], i, seed, g, method,
                                    traffic["lr_gen"], traffic["lr_dis"], proto, banks, quant)
            rec.after_step(losses)
    return rec.readings()


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale (amax to 448)
    and back, in its own dtype."""
    scale = 448.0 / x.detach().abs().amax().float().clamp(min=1e-12)
    return ((x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Rounds the value to float8 on the way forward and its gradient on
    the way back."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, grad):
        return _e4m3(grad)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """The precision below bfloat16, for the control: the value rounded to
    float8 e4m3 with a per-tensor scale, and so is the gradient that flows
    back through it, as the program's backward runs in bfloat16 wherever its
    forward does."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Fp8.apply(x)
    return _e4m3(x)
