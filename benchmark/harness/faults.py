"""Faults planted under the timed path, each a wrapper of the program's
step (``fault(step, program) -> step``), for the check that ``correct``
comes out false: a step that returns its state unchanged, or leaves part
of it unchanged (both discriminators unstepped; the prototype banks not
committed), half of the batch left out (the mean taken over the rest),
and an answer altered where it is produced (one image's mask logits
raised to a confident answer; K1's MC samples of one image made alike).
One card has no exchange between chips to leave out. :data:`PROTOTYPE`
names the faults of parts that only a prototype-phase step has."""

from __future__ import annotations

import copy

import torch


def unchanged(step, program):
    """Every module's parameters and statistics, the optimizers' state and
    the banks are put back after the step."""

    def run(batch):
        st = program.state
        saved = ([copy.deepcopy(m.state_dict()) for m in program.modules().values()],
                 [copy.deepcopy(o.state_dict()) for o in program.optimizers().values()],
                 {k: v.clone() for k, v in program.banks().items()},
                 st.proto_src_init.clone(), st.proto_trg_init.clone(), st.step)
        metrics = step(batch)
        with torch.no_grad():
            for m, sd in zip(program.modules().values(), saved[0]):
                m.load_state_dict(sd)
            for o, sd in zip(program.optimizers().values(), saved[1]):
                o.load_state_dict(sd)
        st = program.state
        if saved[2]:
            st.proto_src, st.proto_trg = saved[2]["src"], saved[2]["trg"]
        st.proto_src_init, st.proto_trg_init, st.step = saved[3], saved[4], saved[5]
        return metrics

    return run


def half_batch(step, program):
    """The step sees the first half of every batch's rows."""

    def run(batch):
        return step({k: v[: v.shape[0] // 2] for k, v in batch.items()})

    return run


def altered(step, program):
    """The model's answer altered where it is produced: the mask logits of
    the batch's first image raised by :data:`ALTER_BY` at the generator's
    output, a confident answer of cup and disc over the whole image."""
    gen = program.state.gen
    produce = gen.heads_suffix

    def heads_suffix(*args, **kwargs):
        out = produce(*args, **kwargs)
        logits = out.mask_logits.clone()
        logits[0] = logits[0] + ALTER_BY
        return out._replace(mask_logits=logits)

    gen.heads_suffix = heads_suffix
    return step


ALTER_BY = 4.0  # logits: a probability of 0.98 where the untrained model says about 0.5


def dis_unstepped(step, program):
    """Both discriminators' parameters and their optimizers' state are put
    back after the step: the generator steps, the discriminators do not."""

    def run(batch):
        mods = [m for k, m in program.modules().items() if k != "gen"]
        opts = [o for k, o in program.optimizers().items() if k != "gen"]
        saved = ([copy.deepcopy(m.state_dict()) for m in mods],
                 [copy.deepcopy(o.state_dict()) for o in opts])
        metrics = step(batch)
        with torch.no_grad():
            for m, sd in zip(mods, saved[0]):
                m.load_state_dict(sd)
            for o, sd in zip(opts, saved[1]):
                o.load_state_dict(sd)
        return metrics

    return run


def banks_unchanged(step, program):
    """The EMA prototype banks and their set flags are put back after the
    step: the step's commit of the banks is lost."""

    def run(batch):
        st = program.state
        saved = st.proto_src, st.proto_trg, st.proto_src_init, st.proto_trg_init
        metrics = step(batch)
        st = program.state
        st.proto_src, st.proto_trg, st.proto_src_init, st.proto_trg_init = saved
        return metrics

    return run


def k1_altered(step, program):
    """K1's answer altered where it is produced: its T MC samples of the
    batch's first target image all made equal to the first sample (as a
    kernel that ignored the sample in its dropout draw would give), so
    that image's MC std is 0."""
    from uda_clr_tpu_torch.train import steps as steps_mod

    k1 = steps_mod.fused_mask_head_split
    t = int(program.cfg.method.mc_samples)

    def altered_k1(*args, **kwargs):
        out = k1(*args, **kwargs).clone()  # [T * B, h, w, 2], sample-major
        b = out.shape[0] // t
        out[b::b] = out[0]
        return out

    def run(batch):
        steps_mod.fused_mask_head_split = altered_k1
        try:
            return step(batch)
        finally:
            steps_mod.fused_mask_head_split = k1

    return run


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "dis_unstepped": dis_unstepped, "banks_unchanged": banks_unchanged,
          "k1_altered": k1_altered}
PROTOTYPE = ("banks_unchanged", "k1_altered")  # faults of the prototype phase's parts


def for_traffic(traffic: dict) -> list[str]:
    """The faults a cell with this traffic mix can have."""
    return sorted(f for f in FAULTS if traffic["proto_phase"] or f not in PROTOTYPE)
