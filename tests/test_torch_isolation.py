"""The port stands alone: importing uda_clr_tpu_torch and every one of its
modules, or running chip_smoke.py's imports, loads neither JAX nor any
module of the JAX package, and needs none of Pillow, PyYAML, cv2, orbax or
tensorboard, which a CUDA machine may lack: a fresh interpreter that
refuses to import those imports every port module and chip_smoke.py, runs
one ``train_transforms(64, wire="u8")`` sample (through the native
library) and ``build_config([])``, builds a TransNorm model and a model on
each of the other three backbones, evaluates a model over two synthetic
images with postprocessing and contour overlays, writes a heatmap, a
validation strip and a scalar image, and runs data parallelism's
collectives and checks in one process (parallel/). The benchmarks
(``bench``, ``bench_eval``) and their modules (``utils.benchmarking``,
``utils.hostfeed``, ``utils.devinfo``), and the measurement tools
(``roofline_closure`` with ``utils.opcount``, ``bench_norm_ab``,
``bench_batch_scaling``, ``bench_e2e``, ``ab_mc_fast``, ``bench_pipeline``,
``bench_loader_backend``) and the long-horizon harness (``longrun``) are
among the modules imported; none loads the repo's ``tools`` package.
Checked in a fresh interpreter, since this test process has both loaded."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import uda_clr_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys

BLOCKED = ('PIL', 'yaml', 'cv2', 'orbax', 'tensorboard')


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked: the port must run without it')


sys.meta_path.insert(0, Refuse())
import numpy as np
import uda_clr_tpu_torch
names = ['uda_clr_tpu_torch'] + [m.name for m in pkgutil.walk_packages(
    uda_clr_tpu_torch.__path__, 'uda_clr_tpu_torch.')]
for name in names:
    importlib.import_module(name)
# the benchmarks and the modules they stand on
for name in ('bench', 'bench_eval', 'utils.benchmarking', 'utils.hostfeed', 'utils.devinfo',
             'roofline_closure', 'utils.opcount', 'bench_norm_ab', 'bench_batch_scaling',
             'bench_e2e', 'ab_mc_fast', 'bench_pipeline', 'bench_loader_backend', 'longrun'):
    assert 'uda_clr_tpu_torch.' + name in names, name
import runpy
runpy.run_path('chip_smoke.py', run_name='chip_smoke')
from uda_clr_tpu_torch.cli import build_config
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.data.transforms import train_transforms
sample = SyntheticFundus(1, 92, transform=train_transforms(64, wire='u8')).get(
    0, np.random.default_rng(0))
assert sample['image'].shape == (64, 64, 3) and sample['image'].dtype == np.uint8
assert build_config([]).run.max_epoch == 500
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.tools.cal_prototype import compute_prototypes
tn = DeepLab(norm='tn')
assert 'backbone.features.0.1.running_var_target' in tn.state_dict()
for backbone, key in (('resnet', 'backbone.layer4.2.bn3.running_var'),
                      ('xception', 'backbone.block20.rep.8.running_var'),
                      ('drn', 'backbone.layer8.1.running_var')):
    assert key in DeepLab(backbone=backbone).state_dict()
import tempfile
from uda_clr_tpu_torch.data import native
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.png import read_png
from uda_clr_tpu_torch.data.transforms import eval_transforms
from uda_clr_tpu_torch.tools.evaluate import evaluate
from uda_clr_tpu_torch.utils import logging, visualize
assert native.available()
tmp = tempfile.mkdtemp()
loader = BatchLoader(SyntheticFundus(2, 92, transform=eval_transforms(64)), 2, shuffle=False,
                     drop_last=False, num_workers=1)
assert set(evaluate(DeepLab().eval(), loader, postprocess=True, save_viz=tmp)) >= {'cup_dice'}
visualize.draw_mask(np.zeros((8, 8, 2)), tmp, 'a.png')
visualize.save_val_img(tmp, 0, [np.zeros((8, 32, 3))])
writer = logging.ScalarWriter(tmp)
writer.add_image('a/b', np.ones((8, 8)), 1)
writer.close()
assert read_png(tmp + '/tensorboard/images/a_b_1.png')[0].shape == (8, 8, 1)
assert read_png(tmp + '/overlay/' + sample['img_name'].split('.')[0] + '.png')[0].shape[2] == 3
import torch
from uda_clr_tpu_torch.parallel import distributed, mesh, reduce
assert distributed.world_size() == 1 and distributed.rank_device('cpu').type == 'cpu'
mesh.check_mesh((1,), 1)
x = torch.ones(3)
m = {'a': x[0]}
assert reduce.all_sum(x) is x and reduce.mean_metrics(m) is m
assert reduce.replica_gap([x], torch.device('cpu')) == 0.0
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.')
             or m == 'flax' or m.startswith('flax.')
             or m == 'uda_clr_tpu' or m.startswith('uda_clr_tpu.')
             or m == 'tools' or m.startswith('tools.')
             or m.split('.')[0] in BLOCKED)
print(len(names))
print(' '.join(bad))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.splitlines()[-2:]  # the probe's last two lines
    modules = list(pkgutil.walk_packages(uda_clr_tpu_torch.__path__, "uda_clr_tpu_torch."))
    assert int(count) == len(modules) + 1 >= 72
    assert bad == "", f"the port loaded: {bad}"


def test_port_sources_name_no_jax():
    """No source line of the port or of chip_smoke.py imports JAX, the JAX
    package or one of the blocked packages (exact names: uda_clr_tpu_torch
    shares the prefix)."""
    files = sorted((ROOT / "uda_clr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "uda_clr_tpu", "PIL", "yaml",
                                   "cv2", "orbax", "tensorboard"), \
                    f"{path.relative_to(ROOT)}:{n}: {line.strip()}"
