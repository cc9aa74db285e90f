"""The port's long-horizon harness (uda_clr_tpu_torch/longrun.py) and its
comparison with the JAX package (longrun_port_parity.py), at toy length
on the CPU (32^2, B 2, T 2 unless said):

* two runs of the same configuration are bitwise equal (no random draw
  enters a family run with dropout off);
* the chaos control changes exactly one tensor of the start, by <= 1e-6
  of its largest entry;
* the smoothed gap equals the JAX tools' summary
  (tools/_longrun_common.print_rel_diff_summary) on the same rows;
* the CLI writes its CSV and JSON line, and raises without a card;
* the port's loader yields the JAX tools' first batch, and the disk-bank
  method's epoch advances with the loader;
* ``posal`` leaves its entropy discriminator bit-frozen;
* ``longrun_port_parity.main`` on the flagship for 2 iterations writes its
  columns and holds iteration 0 to the step tests' tolerances. It runs at
  64^2, where those tolerances were measured: at 32^2 ASPP's norms see 2x2
  pixels per image and iteration 0's loss_seg reads 1.9e-4 between the
  frameworks, with JAX 2.1e-4 and the port 1.8e-5 from the port's float64
  result, so float32 noise there."""

import contextlib
import csv
import io
import json

import numpy as np
import pytest
import torch

from tests.torch_step_harness import RTOL, two_threads  # noqa: F401  (the fixture)
from uda_clr_tpu_torch import longrun
from uda_clr_tpu_torch.train.state import create_train_state

pytestmark = pytest.mark.usefixtures("two_threads")
SIZE, B, T = 32, 2, 2


def _cfg(method="prototype_full"):
    cfg = longrun.config(method)
    cfg.method.mc_samples = T
    return cfg


def _tensors(state) -> dict:
    out = {}
    for name in ("gen", "dis", "dis2", "teacher", "initial", "cls2"):
        module = getattr(state, name)
        if module is not None:
            out.update({f"{name}.{k}": v for k, v in module.state_dict().items()})
    out.update({f"bank.{k}": v for k, v in (state.proto_bank or {}).items()})
    return out


def test_two_runs_are_bitwise_equal():
    batches = longrun.stream(3, SIZE, B)
    with longrun.settings("off"):
        a, b = (longrun.run("prototype_full", _cfg(), batches, "cpu", SIZE) for _ in range(2))
    assert a["rows"] == b["rows"] and a["dice"] == b["dice"]
    ta, tb = _tensors(a["state"]), _tensors(b["state"])
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("method", ["prototype_full", "prototype_wotn", "bcdm"])
def test_chaos_changes_one_tensor_by_one_part_in_a_million(method):
    cfg = _cfg(method)
    plain = _tensors(longrun.build_state(method, cfg, "cpu"))
    chaos = _tensors(longrun.build_state(method, cfg, "cpu", perturb=longrun.CHAOS))
    assert plain.keys() == chaos.keys()
    moved = [k for k in plain if not torch.equal(plain[k], chaos[k])]
    assert moved == [f"gen.{longrun.CHAOS_KEY}"]
    a, b = chaos[moved[0]], plain[moved[0]]
    assert 0.0 < float((a - b).abs().max() / b.abs().max()) <= 1e-6


def test_spread_and_seeded_bank_at_the_start():
    """The seeded start of the disk-bank method: the mask and boundary
    heads' last convs x10 (the initial model's too), the bank of seeded
    normals; the flagship spreads the mask head alone."""
    cfg = _cfg("prototype_wotn")
    state = longrun.build_state("prototype_wotn", cfg, "cpu")
    raw = create_train_state(cfg, seed=0, device="cpu", method="prototype")
    for model in (state.gen, state.initial):
        sd = model.state_dict()
        for k in longrun.MASK_OUT + longrun.BOUNDARY_OUT:
            torch.testing.assert_close(sd[k], raw.gen.state_dict()[k] * 10.0, rtol=0, atol=0)
    bank = longrun.seeded_bank()
    for k, v in state.proto_bank.items():
        np.testing.assert_array_equal(v.numpy(), bank[k])
    flagship = longrun.build_state("prototype_full", _cfg(), "cpu").gen.state_dict()
    k = longrun.BOUNDARY_OUT[0]
    assert torch.equal(flagship[k], raw.gen.state_dict()[k])


def test_gap_equals_the_jax_tools_summary():
    from tools import _longrun_common as C

    rng = np.random.default_rng(0)
    keys = ("loss_all", "loss_D")
    rows = [{f"{fw}_{k}": float(v) for fw in ("jax", "torch")
             for k, v in zip(keys, rng.uniform(0.5, 2.0, 2) * (1 + 0.1 * rng.standard_normal()))}
            for _ in range(40)]
    rows[3]["torch_loss_D"] = 1e-5  # under the floor
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        C.print_rel_diff_summary(rows, keys)
    for line, k in zip(out.getvalue().splitlines(), keys):
        words = line.split()
        mine = longrun.gap([r[f"jax_{k}"] for r in rows], [r[f"torch_{k}"] for r in rows])
        assert words[0] == k
        assert float(words[words.index("mean") + 1]) == round(mine["mean"], 4)
        assert float(words[words.index("max") + 1]) == round(mine["max"], 4)


def test_cli_writes_its_csv_and_json_and_needs_a_card(tmp_path, capsys):
    out = tmp_path / "lr.csv"
    res = longrun.main(["--method", "posal", "--device", "cpu", "--iters", "3", "--size",
                        str(SIZE), "--chaos", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    keys = longrun.FAMILY["posal"].keys
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["iter", "epoch"] + [f"{r}_{k}" for r in ("port", "chaos")
                                                 for k in keys]
    assert len(rows) == 3 and set(res["gaps"]) == {"chaos"}
    assert all(np.isfinite(float(v)) for r in rows for v in r.values())
    assert res["runs"]["port"]["launches"] == {"k1": 0, "k3_fwd": 0, "k3_bwd": 0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            longrun.main(["--method", "posal", "--iters", "1"])


def test_port_loader_yields_the_jax_tools_batches_and_the_bank_epoch_ramps():
    from tools import _longrun_common as C

    want = longrun.take(*C.train_streams(SIZE, B), 13)
    got = longrun.stream(13, SIZE, B)
    for (ew, sw, tw), (eg, sg, tg) in zip(want[:1], got[:1]):
        assert ew == eg == 0
        for k in ("image", "map", "boundary"):
            np.testing.assert_array_equal(sg[k], sw[k], err_msg=k)
            np.testing.assert_array_equal(tg[k], tw[k], err_msg=k)
    # 24 images in batches of 2: the bank method's epoch moves at iteration 12
    assert [e for e, _, _ in got] == [0] * 12 + [1]


def test_posal_leaves_the_entropy_discriminator_frozen():
    cfg = _cfg("posal")
    start = longrun.build_state("posal", cfg, "cpu")
    with longrun.settings("off"):
        res = longrun.run("posal", cfg, longrun.stream(2, SIZE, B), "cpu", SIZE)
    state = res["state"]
    assert state.dis2 is not None and not state.dis2_opt.state
    for k, v in start.dis2.state_dict().items():
        assert torch.equal(state.dis2.state_dict()[k], v), k
    assert not any(torch.equal(state.dis.state_dict()[k], v)
                   for k, v in start.dis.state_dict().items() if k.endswith("weight"))


def test_port_parity_script_holds_iteration_0(tmp_path, capsys):
    import longrun_port_parity

    out = tmp_path / "parity.csv"
    res = longrun_port_parity.main(["--method", "prototype_full", "--iters", "2", "--out",
                                    str(out)])
    keys = longrun.FAMILY["prototype_full"].keys
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["iter", "epoch"] + [f"{fw}_{k}" for k in keys
                                                 for fw in ("jax", "port")]
    for k in keys:
        j, p = float(rows[0][f"jax_{k}"]), float(rows[0][f"port_{k}"])
        assert abs(p - j) <= RTOL[k][0] * abs(j), k
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["gap"] == res["gap"]
