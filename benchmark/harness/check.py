"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program from the seed through its first steps, through
the window's own call and feed; the plain reference follows the first
three from the same weights and batches. Each side is read alike
(:class:`Recorder`):

* each step's losses;
* the first gradient as each optimizer got it, worked out from the
  optimizer's state after one step (Adam: ``exp_avg / (1 - beta1)``; SGD:
  the momentum buffer, the gradient plus the weight decay's term);
* the change of every running statistic after step 1, and of every
  parameter after the three steps;
* the EMA prototype banks after the first step and after the three
  (prototype cells);
* the first step's tiles of the first image (``_viz``: probability maps,
  boundary logits, the MC std map), which the step returns.

The numbers (:func:`compare`); a cell holds those its file gives limits
for (PERF.md says why these and from which readings). A leaf's gap is
|‖prog‖ - ‖ref‖| over max(‖ref‖, its module's median leaf's ‖ref‖):

* ``stats1_first``: the first norm layer's running statistics after step
  1, the worse of its two buffers' gaps: the batch the step saw;
* ``stats1_median``: the median buffer's gap after step 1: the forward's
  precision through the depth;
* ``grad_median.gen``: the generator's median leaf's gap of the first
  gradient: its backward;
* ``grad_norm.<module>`` (``dis``, ``dis2``): the gap of norms of a
  discriminator's whole first gradient, all its leaves as one: its
  backward (a PatchGAN has ten leaves, too few for a steady median);
* ``change_median.gen``: the generator's median leaf's gap of the change
  after three steps, leaving out leaves whose reference gradient is under
  a thousandth of the median leaf's (they move under Adam by round-off
  alone): Adam's steps;
* ``bank1`` and ``bank``: the EMA prototype banks after the first step
  and after three, each bank's median prototype's gap of norms, the worse
  of the two banks (prototype cells);
* ``std``: the gap of norms of the first image's MC std map at step 1,
  which the MC pass through K1 makes (prototype cells);
* ``loss1.loss_seg``: the relative gap of the segmentation loss at step
  1, which reads the masks the generator answers;
* besides, read and printed but held by no cell: the widest relative gap
  of a loss over the three steps (``loss``) and at step 1 (``loss1``, and
  of each loss at step 1, ``loss1.<loss>``), the worst leaf's gaps
  (``grad``, ``change``, ``stats1``, and per module ``grad.<module>``,
  ``change.<module>``), the median leaf's per module
  (``grad_median.<module>``, ``change_median.<module>``), the
  lower-quartile first gradient over all modules (``grad_q25``), the worst
  prototype's gap (``bank_worst``), and the relative gap
  ‖prog - ref‖ / ‖ref‖ of each of the first image's tiles (``viz.<tile>``)
  and of each bank after three steps (``bank_rel.<bank>``) and after the
  first (``bank1_rel.<bank>``).
"""

from __future__ import annotations

import math
import statistics

import torch

STEPS = 3  # the steps the reference follows
SMALL_GRAD = 1e-3  # leaves whose reference gradient is under this share of the median's


def _norms(named) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named}


class Recorder:
    """Reads one side (program or reference) through its first steps.

    ``modules``: ``{name: nn.Module}`` whose parameters the optimizers
    step; ``optimizers``: ``{name: optimizer of that module}``; ``banks``:
    a function returning ``{name: tensor}`` (empty without banks)."""

    def __init__(self, modules: dict, optimizers: dict, banks=lambda: {}):
        self.modules, self.optimizers, self.banks = modules, optimizers, banks
        self.losses: list[dict] = []
        self.grad: dict = {}
        self.change: dict = {}
        self.bank: dict = {}
        self.bank1: dict = {}
        self.viz: dict = {}
        self.stats1: dict = {}
        with torch.no_grad():
            self._p0 = {f"{m}.{n}": p.detach().clone() for m, mod in modules.items()
                        for n, p in mod.named_parameters()}
            self._b0 = {f"{m}.{n}": b.detach().clone() for m, mod in modules.items()
                        for n, b in mod.named_buffers()}

    def after_step(self, losses: dict) -> None:
        """Call after each of the first :data:`STEPS` steps with its losses."""
        self.losses.append({k: float(v.detach()) for k, v in losses.items()
                            if not k.startswith("_")})
        if len(self.losses) == 1:
            self.grad = _norms(self._first_grads())
            with torch.no_grad():
                bufs = {f"{m}.{n}": b for m, mod in self.modules.items()
                        for n, b in mod.named_buffers()}
                self.stats1 = _norms((k, bufs[k] - b0) for k, b0 in self._b0.items())
            self.viz = {k: v.detach().double().cpu() for k, v in losses.get("_viz", {}).items()
                        if k != "conf_t"}
            self.bank1 = {k: v.detach().double().cpu() for k, v in self.banks().items()}
        if len(self.losses) == STEPS:
            with torch.no_grad():
                params = {f"{m}.{n}": p for m, mod in self.modules.items()
                          for n, p in mod.named_parameters()}
                self.change = _norms((k, params[k] - p0) for k, p0 in self._p0.items())
                self.bank = {k: v.detach().double().cpu() for k, v in self.banks().items()}
            self._p0 = self._b0 = None

    def _first_grads(self):
        for m, opt in self.optimizers.items():
            names = {id(p): n for n, p in self.modules[m].named_parameters()}
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p, {})
                    if "exp_avg" in st:
                        g = st["exp_avg"] / (1.0 - group["betas"][0])
                    elif "momentum_buffer" in st:
                        g = st["momentum_buffer"]
                    else:  # a leaf the step did not reach
                        g = torch.zeros_like(p)
                    yield f"{m}.{names[id(p)]}", g

    def readings(self) -> dict:
        return {"losses": self.losses, "grad": self.grad, "change": self.change,
                "stats1": self.stats1, "bank": self.bank, "bank1": self.bank1, "viz": self.viz}


def _module(leaf: str) -> str:
    return leaf.split(".", 1)[0]


def _medians(norms: dict) -> dict:
    by = {}
    for k, v in norms.items():
        by.setdefault(_module(k), []).append(v)
    return {m: statistics.median(vs) for m, vs in by.items()}


def _leaf_gap(prog: dict, ref: dict, keep=lambda k: True) -> tuple[float, str]:
    """The worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, its module's
    median ‖ref‖); (gap, leaf)."""
    med = _medians(ref)
    worst, where = 0.0, ""
    for k, r in ref.items():
        if not keep(k):
            continue
        den = max(r, med[_module(k)])
        gap = abs(prog.get(k, 0.0) - r) / den if den > 0 else abs(prog.get(k, 0.0))
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def _loss_gap(prog: list, ref: list) -> tuple[float, str]:
    """The widest relative gap of a loss over the steps of ``ref``."""
    if len(prog) < len(ref):
        return math.inf, "steps"
    worst, where = 0.0, ""
    for i, (lp, lr) in enumerate(zip(prog, ref)):
        for k, r in lr.items():
            gap = abs(lp.get(k, math.nan) - r) / max(abs(r), 1e-12)
            if not math.isfinite(gap):
                return math.inf, f"step{i + 1}.{k}"
            if gap > worst:
                worst, where = gap, f"step{i + 1}.{k}"
    return worst, where


def compare(prog: dict, ref: dict) -> dict:
    """``{number: (value, where)}`` of the program's readings against the
    reference's (see the module docstring)."""
    med = _medians(ref["grad"])
    moved = lambda k: ref["grad"].get(k, 0.0) >= SMALL_GRAD * med[_module(k)]  # noqa: E731
    first = next(iter(ref["stats1"]), "").rsplit(".", 1)[0]  # the first norm the input meets
    out = {
        "stats1_first": _leaf_gap(prog["stats1"], ref["stats1"],
                                  lambda k: k.rsplit(".", 1)[0] == first),
        "stats1_median": (_quantile_gap(prog["stats1"], ref["stats1"]), ""),
        "grad_q25": (_quantile_gap(prog["grad"], ref["grad"], q=0.25), ""),
        "loss": _loss_gap(prog["losses"], ref["losses"]),
        "loss1": _loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad": _leaf_gap(prog["grad"], ref["grad"]),
        "change": _leaf_gap(prog["change"], ref["change"], moved),
        "stats1": _leaf_gap(prog["stats1"], ref["stats1"]),
    }
    for k in ref["losses"][0] if ref["losses"] else ():
        out[f"loss1.{k}"] = _loss_gap([{k: prog["losses"][0].get(k, math.nan)}]
                                      if prog["losses"] else [], [{k: ref["losses"][0][k]}])
    for m in sorted(med):
        own = lambda k, m=m: _module(k) == m  # noqa: E731
        out[f"grad_median.{m}"] = (_quantile_gap(prog["grad"], ref["grad"], own), m)
        out[f"change_median.{m}"] = (_quantile_gap(prog["change"], ref["change"],
                                                   lambda k, own=own: own(k) and moved(k)), m)
        out[f"grad_norm.{m}"] = (_whole_gap(prog["grad"], ref["grad"], own), m)
        out[f"grad.{m}"] = _leaf_gap(prog["grad"], ref["grad"], own)
        out[f"change.{m}"] = _leaf_gap(prog["change"], ref["change"],
                                       lambda k, own=own: own(k) and moved(k))
    for k, r in ref["viz"].items():
        out[f"viz.{k}"] = (_rel(prog["viz"].get(k), r), k)
    if "std_t" in ref["viz"]:
        out["std"] = (_norm_gap(prog["viz"].get("std_t"), ref["viz"]["std_t"]), "std_t")
    for name, kind in (("bank1", "bank1"), ("bank", "bank")):
        if ref[kind]:
            out[name] = max((_row_median_gap(prog[kind].get(k), r), k)
                            for k, r in ref[kind].items())
    if ref["bank"]:
        worst = (0.0, "")
        for k, r in ref["bank"].items():
            out[f"bank_rel.{k}"] = (_rel(prog["bank"].get(k), r), k)
            p = prog["bank"].get(k)
            for i in range(r.shape[0]):
                gap = _norm_gap(None if p is None or p.shape != r.shape else p[i], r[i])
                worst = max(worst, (gap, f"{k}[{i}]"))
        out["bank_worst"] = worst
    for k, r in ref["bank1"].items():
        out[f"bank1_rel.{k}"] = (_rel(prog["bank1"].get(k), r), k)
    return out


def _whole_gap(prog: dict, ref: dict, keep) -> float:
    """|‖prog‖ - ‖ref‖| / ‖ref‖ over the kept leaves taken as one vector
    (from their norms)."""
    keys = [k for k in ref if keep(k)]
    rn = math.sqrt(sum(ref[k] ** 2 for k in keys))
    pn = math.sqrt(sum(prog.get(k, 0.0) ** 2 for k in keys))
    gap = abs(pn - rn) / rn if rn > 0 else pn
    return gap if math.isfinite(gap) else math.inf


def _row_median_gap(p, r) -> float:
    """The median over the rows (prototypes) of a bank of each row's gap of
    norms (inf where p is missing)."""
    if p is None or p.shape != r.shape:
        return math.inf
    return statistics.median(_norm_gap(p[i], r[i]) for i in range(r.shape[0]))


def _norm_gap(p, r) -> float:
    """|‖p‖ - ‖r‖| / ‖r‖ (inf where p is missing or not finite)."""
    if p is None or p.shape != r.shape:
        return math.inf
    rn = float(torch.linalg.vector_norm(r))
    gap = abs(float(torch.linalg.vector_norm(p)) - rn) / rn if rn > 0 else \
        float(torch.linalg.vector_norm(p))
    return gap if math.isfinite(gap) else math.inf


def _rel(p, r) -> float:
    """‖p - r‖ / ‖r‖ (inf where p is missing or not finite)."""
    if p is None or p.shape != r.shape:
        return math.inf
    gap = float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))
    return gap if math.isfinite(gap) else math.inf


def _quantile_gap(prog: dict, ref: dict, keep=lambda k: True, q: float = 0.5) -> float:
    """The ``q``-quantile over the kept leaves (the median by default) of
    |‖prog‖ - ‖ref‖| over max(‖ref‖, its module's median ‖ref‖)."""
    med = _medians(ref)
    gaps = sorted(abs(prog.get(k, 0.0) - r) / max(r, med[_module(k)]) for k, r in ref.items()
                  if keep(k))
    if not gaps:
        return 0.0
    if q == 0.5:
        return statistics.median(gaps)
    return gaps[min(int(q * len(gaps)), len(gaps) - 1)]


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number the cell holds a limit for is within it."""
    return all(k in numbers and numbers[k][0] <= lim for k, lim in limits.items())
