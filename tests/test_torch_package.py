"""Package-level contracts of the PyTorch + CUDA port.

* Every module imports with jax, flax, optax and the JAX package blocked:
  the GPU machine has none of them.
* The numpy copies (synthetic fixtures, KITTI calibration) equal the
  JAX package's originals.
* There is no CPU fallback for a kernel: `require_cuda()` raises here,
  each kernel entry point raises on a CPU tensor instead of computing,
  and `chip_smoke.py` exits non-zero without printing its result line.
* The slice's unported options raise and name their ROADMAP item.
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import depthmodelhardening_tpu_torch as port
from depthmodelhardening_tpu.data import synthetic as j_synthetic
from depthmodelhardening_tpu.physics import calibration as j_calibration
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.data import synthetic
from depthmodelhardening_tpu_torch.device import require_cuda
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, build_attack,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    init_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import pool, warp
from depthmodelhardening_tpu_torch.physics import calibration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
BLOCKED = ("jax", "jaxlib", "flax", "optax", "depthmodelhardening_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PORT_DIR], prefix="depthmodelhardening_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 20
    code = "\n".join(
        ["import sys"]
        + [f"sys.modules[{m!r}] = None" for m in BLOCKED]
        + ["import importlib"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["assert not any(k.split('.')[0] in {0!r} and sys.modules[k] "
           "is not None for k in list(sys.modules))".format(BLOCKED)])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|"
                     r"depthmodelhardening_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert not bad


@pytest.mark.parametrize("kw", [dict(), dict(width=60, height=40, seed=3)])
def test_synthetic_object_equals_the_original(kw):
    for got, want in zip(synthetic.make_car_object(**kw),
                         j_synthetic.make_car_object(**kw)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(batch=2, seed=1),
                                dict(batch=1, height=96, width=320, seed=4)])
def test_synthetic_scene_equals_the_original(kw):
    np.testing.assert_array_equal(synthetic.make_scene(**kw),
                                  j_synthetic.make_scene(**kw))


def test_calibration_equals_the_original():
    got, want = calibration.Calibration.default(), \
        j_calibration.Calibration.default()
    for name in ("P", "V2C", "R0"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda()
    with pytest.raises(RuntimeError):
        require_cuda("cpu")


def _kernel_calls():
    x = torch.rand(1, 2, 9, 11)
    inter = torch.rand(1, 3, 8, 5)
    A, B = torch.ones(1, 5), torch.zeros(1, 5)
    g = torch.rand(1, 3, 6, 5)
    return {
        "vertical_resample_fwd": lambda: warp.vertical_resample_fwd_cuda(
            inter, A, B, 6),
        "vertical_resample_bwd": lambda: warp.vertical_resample_bwd_cuda(
            g, A, B, 8),
        "maxpool3x3s2_fwd": lambda: pool.maxpool3x3s2_fwd_cuda(x),
        "maxpool3x3s2_bwd": lambda: pool.maxpool3x3s2_bwd_cuda(
            x, torch.rand(1, 2, 5, 6)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_entry_point_refuses_cpu_tensors(name):
    """A kernel is launched on a CUDA tensor or not at all."""
    kernel = next(k for k in (warp.FWD, warp.BWD, pool.FWD, pool.BWD)
                  if k.name == name)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        _kernel_calls()[name]()
    assert kernel.launches == before


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr

    # alone in a directory, without the package, it fails as well
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def tiny_predictor():
    return predictor_from(init_monodepth2(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("norm,item", [("l_0", "slice 3"),
                                       ("l_2", "slice 5"),
                                       ("Square", "slice 5")])
def test_unported_norms_raise_and_name_their_roadmap_item(
        tiny_predictor, norm, item):
    obj, mask = synthetic.make_car_object(60, 40)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        build_attack(AttackEvalConfig(norm_type=norm), tiny_predictor, obj,
                     mask)


@pytest.mark.parametrize("kw", [dict(attack_crop_w=320, attack_crop_h=256),
                                dict(attack_scale=1),
                                dict(attack_scale=2),
                                dict(attack_view_dtype="bfloat16")])
def test_unported_attack_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PhysObjAttackConfig(obj_h=40, obj_w=60, **kw)
