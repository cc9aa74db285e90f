#!/usr/bin/env python3
"""The port's train steps against the JAX package's over long horizons, on
the CPU: the port's counterpart of the JAX package's long-horizon family
(``tools/longrun_parity{,_bank,_bcdm,_mt,_posal}.py`` and
``tools/longrun_chaos_control.py``), with the JAX package as the reference.

    python longrun_port_parity.py --method {prototype_full,prototype,prototype_wotn,bcdm,
        mean_teacher,posal} [--iters N] [--chaos] --out docs/torch_longrun_parity<_suffix>.csv

The JAX side is built as the JAX tools build it (``tools/_longrun_common``:
the seeded torch models with the logit spread converted to JAX, the same
config, model and streams), so its column is the training of
``docs/longrun_parity*.csv``'s ``jax_*`` columns. The port's state comes
from that JAX state through the weight bridge
(``uda_clr_tpu_torch/convert/from_jax.py:train_state_dicts``: generator,
discriminators, bank, teacher, initial model, second classifier), and one
stream of numpy batches (the JAX tools' loaders) feeds both steps; the
port's own loader must yield the same first two batches. The port's run is
``uda_clr_tpu_torch.longrun.run``; ``--chaos`` adds its chaos control (the
port's stem conv x (1 + 1e-6), same batches).

Raises unless iteration 0 agrees within the step tests' iteration-0
tolerances (copied below), every value is finite, and, under ``posal``,
the entropy discriminator stays bit-frozen on both sides. Writes the CSV
(``iter``, ``epoch``, ``jax_<k>``, ``port_<k>``, with ``--chaos``
``chaos_<k>``; for the disk-bank method the bank vectors' relative L2 gap
``bank_<k>_reldiff``) and prints the smoothed divergence per key, the
discriminators' losses against 2 ln 2, the final validation Dice on each
side, the port's own chaos gap, and a JSON line last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

# iteration 0's relative tolerances of the port's step tests
# (tests/torch_step_harness.py:RTOL and tests/test_torch_step_bcdm.py:BCDM_RTOL)
ITER0_RTOL = {
    "loss_seg": 3e-5, "loss_all": 3e-5, "loss_adv": 1e-6, "loss_D": 1e-6, "loss_D2": 2e-6,
    "loss_consistency": 2e-4, "loss_intra": 3e-4, "loss_inter": 1e-4,
    "loss_cup": 4e-5, "loss_disc": 1.5e-4, "loss_bu": 1.2e-4,
}
# bcdm's loss_seg is phase A's, before any update; its two discrepancies
# follow one Adam step of every parameter (cdd_after five of the backbone's)
# at lr 1e-3 here, 1e-5 in the step test, whose sign noise moves them: they
# are held, with loss_all (their 0.01 share), at 3x the JAX package's own
# gap to its torch transcription at iteration 0 of
# docs/longrun_parity_bcdm.csv (6.7e-2 each, loss_all 6.6e-5)
BCDM_ITER0_RTOL = {"loss_seg": 2.5e-5, "loss_all": 2e-4, "loss_cdd_before": 0.2,
                   "loss_cdd_after": 0.2}


def configure_jax() -> None:
    """The JAX tools' settings: the CPU, one device, full float32 products."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.config.update("jax_default_matmul_precision", "highest")


def jax_side(method: str, size: int, batch: int):
    """(model, step, eval step, initial state) of the JAX package, built as
    the JAX tool of ``method`` builds them."""
    import jax
    import jax.numpy as jnp
    import torch

    from tests.torch_ref import TorchDeepLab
    from tools import _longrun_common as C
    from uda_clr_tpu.convert.torch_import import convert_deeplab_state_dict
    from uda_clr_tpu.train.state import create_train_state
    from uda_clr_tpu.train.steps import make_eval_step, make_train_step
    from uda_clr_tpu_torch.longrun import FAMILY, seeded_bank

    fam = FAMILY[method]
    cfg = C.build_config(mc_samples=fam.mc_samples)
    cfg.method.method = fam.step_method
    model = C.build_model()
    kwargs = {"with_proto_bank": fam.step_method == "prototype",
              "with_teacher": method == "mean_teacher", "with_cls2": method == "bcdm"}
    # the init's random weights are all replaced below; its optimizer
    # states, banks and key are zeros or the key's, as the eager init's
    state = jax.jit(lambda k: create_train_state(model, k, (batch, size, size, 3), **kwargs))(
        jax.random.PRNGKey(0))
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    if method == "bcdm":  # tools/longrun_parity_bcdm.py: two seeded models, no spread
        torch.manual_seed(0)
        tm1 = TorchDeepLab(num_classes=2, output_stride=16)
        tm2 = TorchDeepLab(num_classes=2, output_stride=16)

        def conv(m):
            return convert_deeplab_state_dict({k: v.numpy() for k, v in m.state_dict().items()
                                               if "num_batches_tracked" not in k}, 16)

        (p1, s1), (p2, s2) = conv(tm1), conv(tm2)
        state = state.replace(
            gen_params=tree(p1), gen_stats=tree(s1),
            cls2_params={k: tree(p2[k]) for k in ("aspp", "decoder")},
            cls2_stats={k: tree(s2[k]) for k in ("aspp", "decoder")})
    else:
        tm, tdis, tdis2 = C.build_torch_side()
        if fam.spread_boundary:  # tools/longrun_parity_bank.py:72-77
            with torch.no_grad():
                tm.decoder.last_conv_boundary[8].weight.mul_(10.0)
                tm.decoder.last_conv_boundary[8].bias.mul_(10.0)
        gp, gs, dp, dp2 = (tree(t) for t in C.convert_to_jax(tm, tdis, tdis2))
        state = state.replace(gen_params=gp, gen_stats=gs, dis_params=dp, dis2_params=dp2)
        if fam.step_method == "prototype":
            state = state.replace(proto_bank={k: jnp.asarray(v) for k, v in seeded_bank().items()})
        if method == "prototype_wotn":
            cfg.method.use_weight_rectify = True
            cfg.method.pseudo_from_initial = True
            state = state.replace(initial_params=jax.tree.map(jnp.copy, gp),
                                  initial_stats=jax.tree.map(jnp.copy, gs))
        if method == "mean_teacher":
            cfg.method.teacher_noise = 0.0
            state = state.replace(teacher_params=jax.tree.map(jnp.copy, gp),
                                  teacher_stats=jax.tree.map(jnp.copy, gs))
    step = make_train_step(model, cfg, fam.step_method, proto_phase=fam.proto_phase)
    return model, step, make_eval_step(model), state


def check_same_batches(jax_batches: list, port_batches: list) -> None:
    """The port's loader against the JAX tools' on the first batches."""
    for i, ((ej, sj, tj), (ep, sp, tp)) in enumerate(zip(jax_batches, port_batches)):
        assert ej == ep, (i, ej, ep)
        for side, a, b in (("source", sj, sp), ("target", tj, tp)):
            for k in ("image", "map", "boundary"):
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"batch {i} {side} {k}: the port's loader differs "
                                         f"from the JAX package's")


def d_side(rows: list, prefix: str, key: str) -> dict:
    s = np.array([r[f"{prefix}_{key}"] for r in rows])
    return {"start": float(s[0]), "end": float(s[-1]),
            "max_dev_2ln2": float(np.max(np.abs(s - 2 * np.log(2))))}


def main(argv=None) -> dict:
    import jax
    import jax.numpy as jnp

    from tools import _longrun_common as C
    from uda_clr_tpu.models import layers as jax_layers
    from uda_clr_tpu_torch import longrun
    from uda_clr_tpu_torch.convert.from_jax import train_state_dicts

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", required=True, choices=longrun.METHODS)
    ap.add_argument("--iters", type=int, default=None, help="default: the JAX tool's")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n-data", type=int, default=longrun.N_DATA)
    ap.add_argument("--chaos", action="store_true", help="add the port's 1e-6 chaos control")
    ap.add_argument("--out", required=True, help="the per-iteration CSV")
    args = ap.parse_args(argv)
    method, fam = args.method, longrun.FAMILY[args.method]
    iters, size, b = args.iters or fam.iters, args.size, args.batch
    keys = fam.keys
    t0 = time.time()

    model, step, eval_step, jstate = jax_side(method, size, b)
    # host copies: the JAX step donates its input state
    start = train_state_dicts(jax.tree.map(np.array, jstate))
    jax_dis2 = jax.tree.map(np.array, jstate.dis2_params)
    batches = longrun.take(*C.train_streams(size, b, args.n_data), iters)
    check_same_batches(batches[:2], longrun.stream(2, size, b, args.n_data))

    cfg = longrun.config(method)
    port_banks = []
    each = (lambda i, st: port_banks.append({k: v.clone() for k, v in st.proto_bank.items()})) \
        if fam.step_method == "prototype" else None
    prev = jax_layers._DROPOUT_IMPL
    jax_layers.set_dropout_impl("off")
    try:
        with longrun.settings("off"):
            port = longrun.run(method, cfg, batches, "cpu", size, state_dicts=start, each=each)
            chaos = (longrun.run(method, cfg, batches, "cpu", size, state_dicts=start,
                                 perturb=longrun.CHAOS) if args.chaos else None)
        print(f"# port: {port['seconds']:.0f} s", file=sys.stderr, flush=True)

        rows = []
        for i, (epoch, batch_s, batch_t) in enumerate(batches):
            db = C.device_batch(batch_s, batch_t)
            if method == "mean_teacher":
                db["consistency_weight"] = jnp.float32(longrun.CONSISTENCY)
            jstate, metrics = step(jstate, db, longrun.LR_GEN, longrun.LR_DIS,
                                   epoch if fam.epoch_ramp else longrun.FIXED_EPOCH)
            metrics.pop("_viz", None)
            got = {k: float(v) for k, v in jax.device_get(metrics).items()}
            row = {"iter": i, "epoch": epoch}
            for k in keys:
                row[f"jax_{k}"] = got[k]
                row[f"port_{k}"] = port["rows"][i][k]
                if chaos is not None:
                    row[f"chaos_{k}"] = chaos["rows"][i][k]
            if each is not None:
                for k in port_banks[i]:
                    a, ref = port_banks[i][k].numpy(), np.asarray(jstate.proto_bank[k])
                    row[f"bank_{k}_reldiff"] = float(np.linalg.norm(a - ref)
                                                     / (np.linalg.norm(ref) + 1e-12))
            rows.append(row)
            if i % 10 == 0:
                print(f"[{i}/{iters}] ep{epoch} loss_all jax {row['jax_loss_all']:.4f} port "
                      f"{row['port_loss_all']:.4f} ({time.time() - t0:.0f} s)", flush=True)
        jax_dice = [float(v) for v in C.jax_val_dice(eval_step, jstate, C.val_set(size))]
    finally:
        jax_layers.set_dropout_impl(prev)

    C.write_rows_csv(args.out, rows)  # the record first, then the checks
    # the checks
    tol = BCDM_ITER0_RTOL if method == "bcdm" else ITER0_RTOL
    for k in keys:
        j, p = rows[0][f"jax_{k}"], rows[0][f"port_{k}"]
        rel = abs(p - j) / max(abs(j), 1e-12)
        if rel > tol[k]:
            raise AssertionError(f"iteration 0: {k} port {p} jax {j} rel {rel:.2e} > {tol[k]}")
    bad = [(r["iter"], k) for r in rows for k, v in r.items() if not math.isfinite(v)]
    if bad:
        raise FloatingPointError(f"non-finite values at (iteration, column) {bad[:5]}")
    if method == "posal":  # the port's run raised if its entropy D moved
        for a, c in zip(jax.tree.leaves(jax_dis2),
                        jax.tree.leaves(jax.tree.map(np.array, jstate.dis2_params))):
            np.testing.assert_array_equal(a, c, err_msg="the JAX entropy D moved under posal")
        print("entropy D bit-frozen on both sides")

    longrun_rows = lambda prefix: [{k: r[f"{prefix}_{k}"] for k in keys} for r in rows]
    result = {
        "method": method, "iters": iters, "size": size, "batch": b,
        "gap": longrun.compare(longrun_rows("port"), longrun_rows("jax"), keys),
        "dice": {"jax": jax_dice, "port": port["dice"]},
        "d_side": {f"{fw}_{k}": d_side(rows, fw, k) for fw in ("jax", "port")
                   for k in ("loss_D", "loss_D2") if k in keys},
        "csv": args.out, "seconds": time.time() - t0,
    }
    if chaos is not None:
        result["chaos_gap"] = longrun.compare(longrun_rows("chaos"), longrun_rows("port"), keys)
        result["dice"]["chaos"] = chaos["dice"]
    if each is not None:
        result["bank_reldiff_final"] = {k: rows[-1][f"bank_{k}_reldiff"] for k in port_banks[-1]}

    print(f"\nwrote {args.out} ({iters} iterations, {result['seconds']:.0f} s)")
    print(f"val Dice (cup, disc): jax {np.round(jax_dice, 4).tolist()} port "
          f"{np.round(port['dice'], 4).tolist()}"
          + (f" port+1e-6 {np.round(chaos['dice'], 4).tolist()}" if chaos else ""))
    for k in keys:
        g = result["gap"][k]
        line = f"{k:16s} port vs jax smoothed rel diff: mean {g['mean']:.4f} max {g['max']:.4f}"
        if chaos is not None:
            c = result["chaos_gap"][k]
            line += f"   port chaos: mean {c['mean']:.4f} max {c['max']:.4f}"
        print(line)
    for name, d in result["d_side"].items():
        print(f"{name}: start {d['start']:.6f} end {d['end']:.6f} "
              f"max|dev from 2ln2| {d['max_dev_2ln2']:.6f}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    configure_jax()
    import torch

    torch.set_num_threads(min(2, torch.get_num_threads()))
    main()
