"""The port's config, YAML reader/writer and CLI argument handling against
the JAX package's (uda_clr_tpu/config.py, uda_clr_tpu/cli.py) and PyYAML.
Everything here is exact: dict equality and bitwise-equal text."""

import math
from pathlib import Path

import pytest
import yaml

from uda_clr_tpu import cli as jax_cli
from uda_clr_tpu.config import Config as JaxConfig
from uda_clr_tpu_torch import cli
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.utils import miniyaml

ROOT = Path(__file__).resolve().parents[1]
YAML_FILES = sorted(str(p.relative_to(ROOT)) for p in
                    list((ROOT / "configs").glob("*.yaml")) + list((ROOT / "docs").glob("*.yaml")))


def test_defaults_equal_jax():
    assert Config().to_dict() == JaxConfig().to_dict()


@pytest.mark.parametrize("path", YAML_FILES)
def test_reader_equals_safe_load_on_repo_yaml(path):
    text = (ROOT / path).read_text()
    assert miniyaml.load(text) == yaml.safe_load(text)
    assert Config.from_yaml(text).to_dict() == JaxConfig.from_yaml(text).to_dict()


@pytest.mark.parametrize("text", [
    "1e-3", "1.0e-3", "2.5e-05", "1.0e3", "5.0e-4", "1.", ".5", "-2.5", "+3", "0", "00", "017",
    "09", "0x1f", "0b101", "1_000", "1:30", "1:30.5", "-.inf", ".inf", ".NaN", "yes", "No",
    "on", "OFF", "True", "false", "~", "null", "Null", "", "abc", "runs/x-1", "Drishti-GS",
    "'quoted'", "'it''s'", '"dq"', "''", '""', "'1.0'", "[8]", "[4, 2]", "[]",
])
def test_scalar_resolution_equals_safe_load(text):
    want = yaml.safe_load(f"a: {text}")["a"]
    got = miniyaml.load(f"a: {text}")["a"]
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want), (got, want)


def test_nested_blocks_comments_and_sequences():
    text = ("# header\nrun:   # trailing\n  mesh_shape:\n  - 4\n  - 2\n  out_dir: 'a # b'\n"
            "model:\n  nested:\n    deep: 1.5   # c\n  flag: yes\nempty:\n")
    assert miniyaml.load(text) == yaml.safe_load(text)
    assert miniyaml.load("") is None and miniyaml.load("# only\n") is None


@pytest.mark.parametrize("bad", ["a: &x 1", "a: !!str 1", "a: {b: 1}", "a:\n\t- 1",
                                 "a: 'open", "a: 1\na: 2", "a: 2024-01-01"])
def test_reader_refuses_outside_the_subset(bad):
    with pytest.raises(ValueError):
        miniyaml.load(bad)


def _configs():
    a = Config()
    b = Config()
    b.run.mesh_shape = (8,)
    b.run.stop_epoch = 7
    b.data.data_dir = ""
    b.run.out_dir = "runs/Drishti-GS/prototype_full/pid_True"
    b.optim.lr_dis = 1e-17
    b.model.compute_dtype = "bfloat16"
    c = Config()
    c.run.resume = "yes"  # a string that would resolve to a bool
    c.data.dataset_target = "1.0"
    c.run.initial_resume = "it's: here #1"
    c.method.consistency_rampup = float("inf")
    return [a, b, c]


@pytest.mark.parametrize("index", range(3))
def test_to_yaml_round_trips_and_equals_safe_dump(index):
    cfg = _configs()[index]
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    text = cfg.to_yaml()
    assert text == jcfg.to_yaml()  # byte-equal to yaml.safe_dump
    assert Config.from_yaml(text).to_dict() == cfg.to_dict()
    assert JaxConfig.from_yaml(text).to_dict() == jcfg.to_dict()


def test_unknown_key_raises():
    with pytest.raises(KeyError, match="unknown config key RunConfig.bogus"):
        Config.from_dict({"run": {"bogus": 1}})


ARGVS = [
    [],
    ["--synthetic", "--image-size", "64", "--batch-size", "2", "--bf16", "--wire", "f32"],
    ["--method", "baseline", "--no-pid", "--no-retrify", "--use_TN", "--seed", "3",
     "--lr-gen", "2e-4", "--lr-decrease-rate", "0.5", "--momentum", "0.9"],
    ["--method", "prototype_mt", "--datasetT", "RIM-ONE_r3", "--pro_weight", "0.2",
     "--global_pro_weight", "0.5", "--stop-epoch", "4", "--interval-validate", "2"],
    ["--out", "runs/x", "--resume", "runs/x/checkpoints", "--initial-resume", "w.pth.tar",
     "--num-workers", "4", "--loader-backend", "process", "--profile", "--out-stride", "8"],
    ["--config", "configs/clr_drishti.yaml"],
    ["--config", "configs/beal_rimone.yaml", "--data-dir", "/data", "--out", "o",
     "--resume", "r", "--initial-resume", "i.pth", "--method", "baseline", "--bf16"],
    ["--config", "docs/round5_production_500ep_stage2_config.yaml", "--out", "o2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_build_config_equals_jax(argv):
    argv = [str(ROOT / a) if a.endswith(".yaml") else a for a in argv]
    assert cli.build_config(argv).to_dict() == jax_cli.build_config(argv).to_dict()


def test_device_flag_is_the_only_addition():
    assert cli.build_config(["--device", "cpu"]).to_dict() == jax_cli.build_config([]).to_dict()
    assert cli._parser().parse_args([]).device == "cuda"
