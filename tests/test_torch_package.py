"""Package-level contracts of the PyTorch + CUDA port.

* Every module imports with jax, flax, optax and the JAX package blocked:
  the GPU machine has none of them.
* The numpy copies (synthetic fixtures, KITTI calibration, Monodepth2's
  intrinsics) equal the JAX package's originals.
* There is no CPU fallback for a kernel: `require_cuda()` raises here,
  so does a trainer asked for "cuda", each kernel entry point raises on
  a CPU tensor instead of computing, and `chip_smoke.py` exits non-zero
  without printing its result line.
* The slices' unported options raise and name their ROADMAP item; the
  attack's options take JAX's values and raise JAX's errors.
* Each kernel entry point takes the dtypes it has instances for: D and B
  float32 and bfloat16, A and C float32 only.
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
from depthmodelhardening_tpu.physics import eot as j_eot
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.attacks.pgd_object import PGDObjectAttack
from depthmodelhardening_tpu_torch.data import synthetic
from depthmodelhardening_tpu_torch.device import require_cuda
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    init_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import conv, pool, reproj, warp
from depthmodelhardening_tpu_torch.physics import calibration, eot
from depthmodelhardening_tpu_torch.training.config import (
    DistillConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.distill import DistillTrainer
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
BLOCKED = ("jax", "jaxlib", "flax", "optax", "depthmodelhardening_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PORT_DIR], prefix="depthmodelhardening_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 20
    assert {"depthmodelhardening_tpu_torch." + m for m in (
        "ops.conv", "training.distill", "attacks.l0_object", "ops.color",
        "models.simsiam", "training.adv_synth",
        "training.hardening", "models.pose", "training.checkpoints",
        "evaluation.pose_eval", "attacks.l2_object", "attacks.apgd_object",
        "attacks.square_object", "attacks.random_object",
        "attacks.light_object", "attacks.physical", "attacks.pgd_image",
        "physics.light", "evaluation.presets", "evaluation.clean_eval",
        "evaluation.sweeps")} <= set(mods)
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


@pytest.mark.parametrize("wh", [(1242, 375), (1024, 320), (128, 64)])
def test_monodepth2_K_equals_the_original(wh):
    np.testing.assert_array_equal(eot.monodepth2_K(*wh),
                                  j_eot.monodepth2_K(*wh))


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda()
    with pytest.raises(RuntimeError):
        require_cuda("cpu")


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("make", ["hardening", "distill", "hardening_l0",
                                  "distill_l0", "hardening_mono_bf16"])
def test_trainers_run_on_the_card_or_raise(make, device):
    """A trainer runs on the CUDA card unless given "cpu": without
    `device=`, or asked for "cuda", it checks for the card before it
    builds anything (`device.resolve_device`) and raises here. The
    hardening step at config 4 (the L0 attack, the synthesis, SimSiam,
    the teacher), its mono+stereo bf16 configuration (the pose
    networks) and the L0 distillation likewise; the L0 attack, the
    colour jitter, SimSiam and the synthesis run where their inputs
    are."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    obj, mask = synthetic.make_car_object(width=60, height=40)
    kw = {} if device is None else {"device": device}
    teacher = predictor_from(init_monodepth2(torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if make == "hardening":
            HardeningTrainer(HardeningConfig(supervised_adv=False,
                                             contrastive_learning=False),
                             torch.Generator().manual_seed(0), obj, mask,
                             **kw)
        elif make == "hardening_l0":
            HardeningTrainer(HardeningConfig(),
                             torch.Generator().manual_seed(0), obj, mask,
                             teacher, **kw)
        elif make == "hardening_mono_bf16":
            HardeningTrainer(HardeningConfig(
                selfsup=SelfSupConfig(frame_ids=("0", "-1", "1", "s")),
                compute_dtype="bfloat16"),
                torch.Generator().manual_seed(0), obj, mask, teacher, **kw)
        else:
            DistillTrainer(DistillConfig(adv_type="object_l0" if
                                         make == "distill_l0" else "object"),
                           torch.Generator().manual_seed(0), obj, mask, None,
                           **kw)


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
        "reproj_loss_fwd": lambda: reproj.reproj_loss_fwd_cuda(x, x),
        "reproj_loss_bwd_q": lambda: reproj.reproj_loss_bwd_cuda(
            x, x, torch.rand(1, 9, 11)),
        "reproj_loss_bwd_grad": lambda: reproj.reproj_loss_bwd_cuda(
            x, x, torch.rand(1, 9, 11), need_dy=False),
        "conv3x3_fwd": lambda: conv.conv3x3_valid_cuda(
            x, torch.rand(4, 2, 3, 3), torch.rand(4), elu=True),
        "conv3x3_dgrad": lambda: conv.conv3x3_dgrad_cuda(
            x, torch.rand(2, 4, 3, 3)),
        "conv3x3_fwd_bf16": lambda: conv.conv3x3_valid_cuda(
            x.bfloat16(), torch.rand(4, 2, 3, 3).bfloat16(),
            torch.rand(4).bfloat16(), elu=True),
        "conv3x3_dgrad_bf16": lambda: conv.conv3x3_dgrad_cuda(
            x.bfloat16(), torch.rand(2, 4, 3, 3).bfloat16()),
        "maxpool3x3s2_fwd_bf16": lambda: pool.maxpool3x3s2_fwd_cuda(
            x.bfloat16()),
        "maxpool3x3s2_bwd_bf16": lambda: pool.maxpool3x3s2_bwd_cuda(
            x.bfloat16(), torch.rand(1, 2, 5, 6).bfloat16()),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_entry_point_refuses_cpu_tensors(name):
    """A kernel is launched on a CUDA tensor or not at all."""
    kernel = next(k for k in (warp.FWD, warp.BWD, pool.FWD, pool.BWD,
                              pool.FWD_BF16, pool.BWD_BF16, reproj.FWD,
                              reproj.BWD_Q, reproj.BWD_GRAD, conv.FWD,
                              conv.DGRAD, conv.FWD_BF16, conv.DGRAD_BF16)
                  if k.name == name)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        _kernel_calls()[name]()
    assert kernel.launches == before


@pytest.mark.parametrize("direction", ["forward", "input gradient"])
def test_reflect_entry_points_refuse_cpu_and_float32(direction):
    """Kernel D's reflect-mode wrappers (bf16 only, the pad folded in)
    launch on a CUDA tensor or not at all, and refuse float32 before
    looking at the device."""
    kernel = conv.FWD_BF16 if direction == "forward" else conv.DGRAD_BF16
    call = {"forward": lambda t: conv.conv3x3_reflect_cuda(
                t, torch.rand(4, 2, 3, 3).to(t.dtype)),
            "input gradient": lambda t: conv.conv3x3_dgrad_reflect_cuda(
                t, torch.rand(2, 4, 3, 3).to(t.dtype))}[direction]
    before = kernel.launches
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        call(torch.rand(1, 2, 9, 11).bfloat16())
    with pytest.raises(TypeError, match="bfloat16"):
        call(torch.rand(1, 2, 9, 11))
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


@pytest.mark.parametrize("norm,item", [("l_2", "slice 7"),
                                       ("Square", "slice 7")])
def test_unported_norms_raise_and_name_their_roadmap_item(
        tiny_predictor, norm, item):
    """Every norm type of the JAX package builds (slice 6a); what the
    evaluation still lacks, the image dumps of `dump_dir`, raises and
    names its ROADMAP item before any batch runs."""
    obj, mask = synthetic.make_car_object(60, 40)
    cfg = AttackEvalConfig(norm_type=norm, dump_dir="dumps")
    attack = build_attack(cfg, tiny_predictor, obj, mask)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        evaluate_attacks(tiny_predictor, attack, [], cfg)


@pytest.mark.parametrize("kw", [dict(attack_scale=1),
                                dict(attack_scale=2),
                                dict(attack_view_dtype="bfloat16")])
def test_attack_options_are_accepted(tiny_predictor, kw):
    """The coarse-scale objective and the bf16 view are options of the
    attack's config; the coarse objective reads the head through the
    `predict_scale` hook, which the trainer supplies, and raises JAX's
    ValueError without it."""
    cfg = PhysObjAttackConfig(obj_h=40, obj_w=60, **kw)
    for name, value in kw.items():
        assert getattr(cfg, name) == value
    obj, mask = synthetic.make_car_object(60, 40)
    atk = PGDObjectAttack(tiny_predictor, obj, mask, cfg)
    assert atk.predict_scale is None
    dt = getattr(torch, cfg.attack_view_dtype)
    adv, masks = torch.rand(1, 64, 64, 3).to(dt), torch.ones(1, 64, 64, 1)
    if cfg.attack_scale:
        with pytest.raises(ValueError, match="needs predict_scale"):
            atk._cost_tail(adv, masks, 1.0)
        atk.predict_scale = lambda x: tiny_predictor.model(
            x, head=cfg.attack_scale)
    cost = atk._cost_tail(adv, masks, 1.0)
    assert cost.dtype == torch.float32 and float(cost) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(attack_scale=3), "attack_scale must be 0, 1 or 2"),
    (dict(attack_view_dtype="float16"), "attack_view_dtype must be"),
    (dict(attack_scale_fine_steps=-1), "attack_scale_fine_steps must be"),
])
def test_attack_option_values_raise_jax_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        PhysObjAttackConfig(obj_h=40, obj_w=60, **kw)


def test_hardening_bf16_names_its_slice():
    """The hardening trainer takes the compute dtypes DistillConfig takes
    and raises DistillConfig's ValueError for another."""
    assert HardeningConfig(compute_dtype="bfloat16").compute_dtype == \
        "bfloat16"
    for cfg in (HardeningConfig, DistillConfig):
        with pytest.raises(ValueError, match="compute_dtype must be"):
            cfg(compute_dtype="float16")


@pytest.mark.parametrize("name,call", [
    ("warp A forward", lambda t: warp.vertical_resample_fwd_cuda(
        t, torch.ones(1, 5), torch.zeros(1, 5), 6)),
    ("warp A adjoint", lambda t: warp.vertical_resample_bwd_cuda(
        t, torch.ones(1, 5), torch.zeros(1, 5), 8)),
    ("reprojection C forward", lambda t: reproj.reproj_loss_fwd_cuda(t, t)),
    ("reprojection C backward", lambda t: reproj.reproj_loss_bwd_cuda(
        t, t, torch.rand(1, 9, 11).to(t.dtype))),
])
def test_float32_only_kernels_refuse_bf16(name, call):
    """Warp A and kernel C have float32 instances only: a bf16 tensor
    raises before anything is launched (warp A stays float32 under the
    bf16 view, as in the JAX package)."""
    t = torch.rand(1, 3, 9, 11 if "C" in name else 5).bfloat16()
    with pytest.raises(TypeError, match="float32"):
        call(t)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("op", ["conv", "pool"])
def test_kernels_refuse_other_dtypes(op, dtype):
    """Kernels D and B take float32 and bfloat16 only, on every device:
    another dtype raises, never a silent cast."""
    x = torch.rand(1, 2, 9, 11, dtype=dtype)
    w = torch.rand(3, 2, 3, 3, dtype=dtype)
    entry, dispatch = {
        "conv": (lambda: conv.conv3x3_valid_cuda(x, w),
                 lambda: conv.conv3x3_valid(x, w)),
        "pool": (lambda: pool.maxpool3x3s2_fwd_cuda(x),
                 lambda: pool.maxpool3x3s2(x)),
    }[op]
    for fn in (entry, dispatch):
        with pytest.raises(TypeError, match="bfloat16"):
            fn()
