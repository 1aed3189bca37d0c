"""The cases of the data-parallel tests (tests/test_torch_parallel.py),
each a function of a mesh: every rank of a two-process gloo group runs
it on its rows (tests/parallel_ranks.py), and the test process runs it
with mesh=None on the global batch. Torch and numpy only.

Sizes of the JAX package's hardening tests (`tests/test_training.py:
27-29`): the model at 64x192, 96x320 frames and scenes, a 24x36 car,
batch 4, attack batch 2, steps 2 (up to 4 L0 iterations); the student
and the teacher from the golden weights (tests/golden_common.py).
"""

import contextlib
import hashlib
import io
import math
import os

import torch
import torch.nn as nn

import golden_common
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.attacks.l0_object import L0ObjectAttack
from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.parallel.batchnorm import global_batchnorm
from depthmodelhardening_tpu_torch.physics.eot import TRAIN_DIST_RANGE
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, DistillConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.distill import DistillTrainer
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer

H, W = 64, 192
ORI_H, ORI_W = 96, 320
OBJ_H, OBJ_W = 24, 36
B, ATK_B, STEPS = 4, 2, 2
WORLD = 2
MONO = ("0", "-1", "1", "s")
SIDE = torch.tensor([True, False, False, True])
FLIP = torch.tensor([False, True, False, True])
# (BatchNorm dims, dtype, global input shape)
BN_CASES = ((2, torch.float32, (4, 6, 5, 7)), (2, torch.bfloat16, (4, 6, 5, 7)),
            (1, torch.float32, (8, 6)), (1, torch.bfloat16, (8, 6)))
PIXEL_THRESHOLDS = (0.1, 1.0)  # no break; a break at `STEPS`
# DepthHints' loss (masked means: global sums under a mesh) on ResNet-18
HINTS = dict(use_depth_hints=True, contrastive_learning=False)


def rows(mesh, n: int) -> slice:
    return slice(None) if mesh is None else mesh.rows(n)


def world(mesh) -> int:
    return 1 if mesh is None else mesh.world_size


def golden_sd():
    return load_reference_state_dict(
        golden_common.resnet18_encoder_state_dict(seed=0),
        golden_common.depth_decoder_state_dict(seed=0))


def golden_predictor(sd):
    model = make_monodepth2()
    model.load_state_dict(sd)
    return predictor_from(model)


def car():
    return make_car_object(OBJ_W, OBJ_H, seed=3)


def scene():
    return torch.from_numpy(make_scene(1, ORI_H, ORI_W, seed=2))


def frames(frame_ids, hints=False):
    """The frames ("s" is "0" shifted 6 columns), with DepthHints' planes
    (the shift's depth, a seeded fifth invalid) when `hints`."""
    f0 = torch.from_numpy(make_scene(B, ORI_H, ORI_W, seed=1))
    out = {"0": f0, "s": torch.roll(f0, 6, dims=2)}
    if "-1" in frame_ids:
        out["-1"] = torch.roll(f0, -4, dims=2)
        out["1"] = torch.roll(f0, 3, dims=1)
    if hints:
        valid = (torch.rand(B, H, W, 1, generator=torch.Generator()
                            .manual_seed(7)) > 0.2).float()
        out["depth_hint"] = 0.58 * W * 0.1 / (6 * W / ORI_W) * valid
        out["depth_hint_mask"] = valid
    return out


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().view(torch.uint8).numpy()
                        .tobytes()).hexdigest()


def outcome(state, metrics) -> dict:
    """What a step left, by name: its metrics, every gradient, the
    BatchNorm running statistics, digests of the parameters and the
    gradients, and how far Adam's moments lie from the first step's on
    those gradients, (1 - b1) g and (1 - b2) g^2 (relative L2, the worst
    tensor): then the gradients carry the moments' comparison. The
    gradients take tens of MB: `slim` drops them."""
    named = [(f"{k}.{n}", p) for k, m in state.modules().items()
             for n, p in m.named_parameters()]
    grads = {n: p.grad.clone() for n, p in named if p.grad is not None}
    moments = 0.0
    for n, p in named:
        if p.grad is not None and p in state.optimizer.state:
            st, g = state.optimizer.state[p], p.grad.double()
            for got, want in ((st["exp_avg"], 0.1 * g),
                              (st["exp_avg_sq"], 1e-3 * g * g)):
                moments = max(moments, float((got.double() - want).norm()
                                             / max(float(want.norm()),
                                                   1e-30)))
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": grads, "moments": moments,
        "grad_digests": {n: digest(g) for n, g in grads.items()},
        "params": {n: digest(p) for n, p in named},
        "stats": {f"{k}.{n}": b.clone() for k, m in state.modules().items()
                  for n, b in m.named_buffers()
                  if n.endswith(("running_mean", "running_var"))}}


def slim(tree):
    """`tree` without the outcomes' gradients (their digests stay)."""
    if isinstance(tree, dict):
        return {k: slim(v) for k, v in tree.items() if k != "grads"}
    if isinstance(tree, list):
        return [slim(v) for v in tree]
    return tree


# -- global BatchNorm and the gradient mean ----------------------------------
def bn_inputs(dims, dtype, shape):
    gen = torch.Generator().manual_seed(21 + dims)
    x = (torch.randn(shape, generator=gen) * 2.0 + 0.5).to(dtype)
    ct = torch.randn(shape, generator=gen).to(dtype)
    w = torch.rand(shape[1], generator=gen) + 0.5
    b = torch.randn(shape[1], generator=gen)
    return x, ct, w, b


def bn_case(mesh, dims, dtype, shape) -> dict:
    """A train-mode BatchNorm on this rank's rows of a seeded global
    input: the output, the input gradient of sum(y * ct), the weight and
    bias gradients (this rank's sums) and the running statistics."""
    x, ct, w, b = bn_inputs(dims, dtype, shape)
    bn = (nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d)(shape[1])
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    if mesh is not None:
        bn = global_batchnorm(bn, mesh)
    r = rows(mesh, shape[0])
    xr = x[r].clone().requires_grad_(True)
    y = bn(xr)
    (y.float() * ct[r].float()).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def psum_case(mesh) -> torch.Tensor:
    """JAX `test_mesh_psum_reduction`: the gradient of mean((x @ w)^2)
    over this rank's rows, averaged over the ranks."""
    x = torch.arange(32.0).reshape(8, 4)[rows(mesh, 8)]
    w = torch.ones(4, requires_grad=True)
    (g,) = torch.autograd.grad(torch.mean((x @ w) ** 2), w)
    if mesh is not None:
        mesh.all_mean([g])
    return g


# -- the hardening step ------------------------------------------------------
def harden_cfg(norm_type="l_0", frame_ids=("0", "s"), **kw):
    return HardeningConfig(
        selfsup=SelfSupConfig(height=H, width=W, frame_ids=frame_ids),
        adv=AdvSynthConfig(norm_type=norm_type, steps=STEPS,
                           attack_batch_size=ATK_B, ori_h=ORI_H,
                           ori_w=ORI_W),
        batch_size=B, learning_rate=1e-4, **kw)


def harden_trainer(mesh, cfg):
    sd = golden_sd()
    obj, mask = car()
    return HardeningTrainer(cfg, torch.Generator().manual_seed(0), obj, mask,
                            golden_predictor(sd), device="cpu",
                            init_state_dict=sd, mesh=mesh)


def step_draws(trainer):
    """The global batch's draws of one step, and the automask's."""
    d = trainer.draw(B, torch.Generator().manual_seed(5))
    d.identity_noise = torch.randn(trainer.identity_noise_shape(B),
                                   generator=torch.Generator().manual_seed(6))
    return d


def refresh_case(mesh, norm_type) -> dict:
    """`refresh_texture` on the golden model: the texture and the
    iterations (PGD's: its steps)."""
    tr = harden_trainer(mesh, harden_cfg(norm_type))
    tex = tr.refresh_texture(tr.make_state(), scene(), step_draws(tr))
    return {"texture": tex, "iterations": getattr(
        tr.attack, "last_iterations", STEPS)}


def l0_gradient_case(mesh):
    """The L0 loop's first iteration's (pos, neg) gradients on the golden
    model, the mask weight on (the ranks' mean under a mesh)."""
    tr = harden_trainer(mesh, harden_cfg())
    atk = tr.attack_student(tr.make_state())
    a = step_draws(tr).attack
    r = rows(mesh, ATK_B)
    full = atk._replicate(scene(), ATK_B // world(mesh))
    _, grads = atk.cost_and_grads(full, a.pos, a.neg, a.z0s[0][r],
                                  a.alphas[0][r], atk.mask_wt)
    return list(grads)


def ulp_nudged(sd, seed):
    """`sd` with every float moved one ulp up or down at random
    (chip_smoke.py's `_ulp_nudged`)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            up = torch.randint(0, 2, v.shape, generator=gen).bool()
            v = torch.nextafter(v, torch.where(up, math.inf, -math.inf))
        out[k] = v
    return out


def nudge(state, seed) -> None:
    """Every weight and statistic of the state's modules one ulp away."""
    for i, m in enumerate(state.modules().values()):
        m.load_state_dict(ulp_nudged(m.state_dict(), seed + i))


def training_half_case(mesh, texture, frame_ids=("0", "s"),
                       nudge_seed=None, **cfg_kw) -> dict:
    """`synth_batch` with `texture` (None: the clean car) and `_update` on
    this rank's rows, of harden_cfg(**cfg_kw): the step's outcome; with
    `nudge_seed`, from every weight one ulp away."""
    tr = harden_trainer(mesh, harden_cfg(frame_ids=frame_ids, **cfg_kw))
    state = tr.make_state()
    if nudge_seed is not None:
        nudge(state, nudge_seed)
    d = step_draws(tr)
    r = rows(mesh, B)
    fr = {k: v[r] for k, v in frames(frame_ids,
                                      tr.cfg.use_depth_hints).items()}
    batch = tr.synth_batch(fr, SIDE[r], FLIP[r],
                           tr.obj_img if texture is None else texture, d)
    return outcome(*tr._update(state, batch, d.identity_noise))


class PixelPredictor:
    """A smooth per-pixel disparity, sigmoid(2 r - g + b / 2)
    (tests/test_torch_l0.py's)."""

    device = torch.device("cpu")

    def __call__(self, x):
        return torch.sigmoid(2.0 * x[..., :1] - x[..., 1:2]
                             + 0.5 * x[..., 2:3])


def pixel_loop_case(mesh, thresh) -> dict:
    """The whole L0 loop on the per-pixel predictor: the texture, the
    iterations and whether the break fired."""
    obj, mask = car()
    cfg = PhysObjAttackConfig(obj_h=OBJ_H, obj_w=OBJ_W, scene_h=H, scene_w=W,
                              ori_h=ORI_H, ori_w=ORI_W, dist_range=tuple(
                                  float(x) for x in TRAIN_DIST_RANGE))
    atk = L0ObjectAttack(PixelPredictor(), obj, mask, cfg, steps=STEPS,
                         mask_wt=0.05, l0_thresh=thresh)
    if mesh is not None:
        atk.grad_mean = mesh.all_mean
    d = atk.draw(torch.Generator().manual_seed(11), ATK_B)
    tex = atk._optimize(atk._replicate(scene(), ATK_B // world(mesh)),
                        d.rows(rows(mesh, ATK_B)))
    return {"texture": tex, "iterations": atk.last_iterations,
            "early_break": atk.last_early_break}


# -- the distillation step -----------------------------------------------------
def distill_setup(mesh):
    sd = golden_sd()
    obj, mask = car()
    cfg = DistillConfig(batch_size=B, steps=STEPS, scene_h=H, scene_w=W,
                        ori_h=ORI_H, ori_w=ORI_W)
    tr = DistillTrainer(cfg, torch.Generator().manual_seed(0), obj, mask,
                        golden_predictor(sd), device="cpu",
                        init_state_dict=sd, mesh=mesh)
    state = tr.make_state()
    d = tr.attack.draw(torch.Generator().manual_seed(7), B).rows(
        rows(mesh, B))
    full = tr.attack._replicate(scene(), B // world(mesh))
    return tr, state, d, full


def distill_texture_case(mesh) -> torch.Tensor:
    """The PGD texture of `DistillTrainer`'s attack on this rank's share."""
    tr, state, d, full = distill_setup(mesh)
    return tr.attack_student(state)._optimize(full, d)


def distill_half_case(mesh, texture) -> dict:
    """The training-time finals of `texture` on this rank's rows and
    `distill_step`: the step's outcome."""
    tr, state, d, full = distill_setup(mesh)
    adv, ben, _ = tr.attack_student(state)._final_outputs(
        full, texture, d.final_z0s, d.final_alphas, False)
    return outcome(*tr.distill_step(state, adv, ben))


# -- the command line --------------------------------------------------------
def cli_argv(tree, log_dir, *extra):
    return ["train-hardening", "--data-path", tree["raw"], "--split-dir",
            tree["splits"], "--split", "par", "--object-data-root",
            tree["obj"], "--object-image", tree["car"], "--weights-folder",
            tree["weights"], "--fine-tune", "--height", str(H), "--width",
            str(W), "--ori-h", str(ORI_H), "--ori-w", str(ORI_W),
            "--batch-size", str(B), "--attack-batch-size", str(ATK_B),
            "--epochs", "1", "--log-frequency", "1", "--compute-dtype",
            "float32", "--log-dir", log_dir, *extra]


# the first run: the plain self-supervised step (no attack, whose
# trajectory parts with the order of sums); the second resumes from its
# checkpoint and takes an L0 step with a robustness val at its start
CLI_PLAIN = ("--no-adv-train",)
CLI_ADV = ("--norm-type", "l_0", "--step", "1", "--no-contrastive-learning",
           "--val-frequency", "1", "--val-eval-count", "1")


def cli_case(tree, log_dir, data_parallel: bool) -> dict:
    """The two train-hardening runs through `cli.main` (with
    --data-parallel under a group): each run's returned state, stdout and
    which of save_state / save_options / MetricsLogger it called, and the
    second run's state as `restore_state` left it."""
    from depthmodelhardening_tpu_torch.cli import main as cli
    from depthmodelhardening_tpu_torch.training import checkpoints
    from depthmodelhardening_tpu_torch.utils import logging as t_logging

    calls, restored = [], []

    def recording(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    def restore(*args, **kwargs):
        state = originals[checkpoints, "restore_state"](*args, **kwargs)
        restored.append(outcome(state, {})["params"])
        return state

    originals = {(m, n): getattr(m, n) for m, n in (
        (checkpoints, "save_state"), (checkpoints, "save_options"),
        (checkpoints, "restore_state"), (t_logging, "MetricsLogger"))}
    for (m, n), fn in originals.items():
        setattr(m, n, restore if n == "restore_state" else recording(n, fn))
    runs = []
    try:
        for extra in (CLI_PLAIN, CLI_ADV):
            argv = cli_argv(tree, log_dir, *extra) + (
                ["--data-parallel"] if data_parallel else [])
            out = io.StringIO()
            del calls[:]
            with contextlib.redirect_stdout(out):
                state = cli.main(argv, device="cpu")
            runs.append({"outcome": outcome(state, {}),
                         "stdout": out.getvalue(), "calls": list(calls)})
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
    return {"runs": runs, "restored": restored}


def write_tree(root) -> dict:
    """A raw drive of 4 frames (split "par": 4 train lines, one step at
    batch 4), an object tree of 4 scenes, a 300 x 60 car and a weights
    folder of the golden weights at 64x192 (tests/test_torch_cli.py's)."""
    import kitti_trees as kt
    from depthmodelhardening_tpu_torch.training import checkpoints

    raw, drive = kt.write_raw_tree(os.path.join(root, "raw"), 4, 120, 400,
                                   seed=20)
    splits = kt.write_split(os.path.join(root, "splits"), "par", train=[
        f"{drive} {fr} {side}" for fr, side in ((1, "l"), (2, "r"),
                                                (1, "r"), (2, "l"))])
    obj = os.path.join(root, "object")
    kt.write_object_tree(obj, 4, 125, 414, seed=40)
    car_path = kt.write_car(os.path.join(root, "BMW.png"), 300, 60, seed=7)
    weights = checkpoints.export_reference_pth(root, 0, golden_sd(),
                                               height=H, width=W)
    return {"raw": raw, "splits": splits, "obj": obj, "car": car_path,
            "weights": weights}


def rank_results(mesh, tree, log_dir) -> dict:
    """Every case on this rank (or alone, mesh=None), in one dict."""
    out = {"bn": [bn_case(mesh, *c) for c in BN_CASES],
           "psum": psum_case(mesh),
           "l0": refresh_case(mesh, "l_0"),
           "linf": refresh_case(mesh, "l_inf"),
           "l0_grads": l0_gradient_case(mesh),
           "pixel": [pixel_loop_case(mesh, t) for t in PIXEL_THRESHOLDS],
           "distill_texture": distill_texture_case(mesh)}
    out["half"] = training_half_case(mesh, out["l0"]["texture"])
    out["mono"] = training_half_case(mesh, None, MONO)
    out["hints"] = training_half_case(mesh, None, **HINTS)
    out["distill"] = distill_half_case(mesh, out["distill_texture"])
    out["cli"] = cli_case(tree, log_dir, mesh is not None)
    return out
