"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: require a CUDA card of capability >= 9.0, print its name and
   power limit as nvidia-smi reports them, switch to plain float32
   numerics (TF32 off, cuDNN off: `device.use_f32_numerics`).
2. build: compile every kernel in depthmodelhardening_tpu_torch/csrc/
   with nvcc into build/torch_kernels/, one nvcc per source, in
   parallel; print each kernel's registers, stack frame and local
   memory as `cuobjdump --dump-resource-usage` reads them from the built
   libraries (NO_SPILL's kernels must have neither stack nor local
   memory: no spill).
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes its main path gives it: max abs error, median
   CUDA-event time on the card alone (`cuda_ms`: the launches queued
   behind a spin; a kernel's time also with the host time in front of
   its launch, the row's `host_ms`) of both and of the one PyTorch
   library call that computes the same function (where there is one),
   and the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s float32, the larger, counted from this
   run's data; for kernel D also 3 TF32 operations per float32 one over
   the tensor cores' 495 TFLOP/s, its row's bound). The
   pool backward B2 bit for bit, also at the distillation step's shape
   and at shapes that straddle its tiles; kernel C both ways bit for
   bit, also at shapes that straddle its tiles; warp A on random, ragged
   (maps and strips), the attack's own row maps (timed at batch 12
   and 32, the row's times from the attack's maps at batch 12) and the
   hardening synthesis' (the 300x200 car at 375x1242 into its 248x296
   tile through either eye's extrinsic, 7 and 4 channels), its
   forward equal to the plain version, its adjoint bit for bit against
   a float32 sum over tile rows in increasing order, the kernel's own
   order. Kernel D (the decoder's narrow
   3x3 convs) at the four convs of the scale-0 path at batch 32,
   1024x320, at ragged shapes (1, 3, 13, 64 channels in and out, 37x53)
   and at the 320x256 attack crop: forward, forward with bias + ELU, and
   input gradient. Then the bf16 instances of D and B at the bench
   configuration's shapes: D (the reflect pad folded in) within one bf16
   ulp of its plain version (float32 arithmetic, one rounding; plus 1e-5
   of the output's largest magnitude where the float32 sum cancels) in
   reflect mode (unpadded x in, dx out) and in zero-border mode (xp in,
   d xp out) at the decoder's convs at 1024x320, on the 320x256 crop, at
   ragged shapes on both staging paths (W % 8 != 0 and == 0) and at maps
   with H or W in {1, 2, 3}; its rows timed over one decoder pass on the
   crop, each conv beside the same run's reflect_pad1 + zero-border
   launch (forward) and zero-border launch + the pad's backward (input
   gradient), which the fused pass must beat, against F.conv2d and
   conv2d_input on xp in bf16 with cuDNN on, bound by the bytes of x, w,
   b and out (g, w and dx) over 3.35 TB/s or operations over 989 TFLOP/s
   (dense bf16); B1 and B2 equal to theirs (torch.equal) on the crop's
   and the full frame's stem (both timed), at ragged shapes that
   straddle the bf16 kernels' row strips (W % 8 != 0 with W even and
   odd, W % 16 != 0 with W % 8 == 0, H and W in {1, 2, 3}), on views
   that are not 16-byte aligned, and on sparse inputs whose cotangents
   make the backward's float32 sum order show in the bits. Every pool
   kernel (B1, B2 and their bf16 instances) on inputs holding NaN
   (inside a window, on a window's edge, filling a window, scattered):
   the forward NaN exactly where the plain version's is and equal
   elsewhere, the backward equal to the plain version.
4. golden: the port's Monodepth2-18 at 96x320 with the deterministic
   reference-layout weights of tests/golden_common.py against the
   frozen PyTorch-reference outputs in tests/golden/monodepth2_rand.npz.
5. slice: the L-inf PGD object-texture attack evaluation at full width
   (Monodepth2-18, 1024x320, batch 12, 10 steps, 2 batches of synthetic
   375x1242 scenes) through build_attack + evaluate_attacks, with every
   launch counter reset before and read after; then a check that 10
   steps lower the targeted cost below its value at the random start.
6. breakdown: median CUDA-event ms of each layer of one PGD step, of the
   finals and of the metrics, at the slice's shapes.
7. idle: the device idle share of one attack call, from a torch.profiler
   trace.
8. train: the self-supervised stereo training step (BASELINE config 2)
   through HardeningTrainer.selfsup_frames_step at the CLI's defaults
   (Monodepth2-18, 4 scales, 1024x320, batch 32, frames ("0", "s"),
   375x1242 synthetic frames whose "s" eye is a column-shifted copy,
   Adam at lr 1e-5, from a seeded from-scratch init): first one small
   step on the card against the same step on the CPU's plain versions;
   then 2 warm-up steps and 5 timed steps, with every launch counter
   reset before the timed steps and read after; checks that the loss is finite, the weights and BatchNorm
   statistics moved and the step count rose; then that steps on one
   fixed batch at lr 1e-4 lower the loss; then the median CUDA-event ms
   of batch building, model forward, losses, backward and optimizer
   step, and the idle share of one step.
9. distill: the distillation step (BASELINE config 3) through
   DistillTrainer.train_step at the DistillConfig defaults (Monodepth2-18
   at 1024x320 float32, L-inf PGD-10 object attack, eps 0.1, alpha
   0.005, full-frame objective, Adam lr 1e-4) at batch 32, teacher and
   student from the golden weights, synthetic 375x1242 scenes and the
   300x200 car: first one small step on the card against the same step
   on the CPU's plain versions; then 2 warm-up and 5 timed steps with
   every launch counter reset before the timed steps and read after
   (kernel D must launch 48 times forward and 44 times backward per
   step, and compute weight gradients for the student only); checks
   that the loss is finite, the weights and BatchNorm statistics moved
   and the unused disparity heads did not; that Adam steps on one fixed
   adversarial batch lower the MSE; one step with the cropped objective
   (320x256) launches D at the crop's shape; then the breakdown of a
   step, its device ms by kernel, its idle share and its reflection-pad
   kernels (ms and launches, as predicted: every decoder conv pads).
10. bench: the distillation step in bench.py's configuration
   (bench.py:81-115): DistillConfig with compute_dtype bfloat16, the
   320x256 cropped objective, the bf16 attack view and fold_bn, PGD-10,
   batch 32 at 1024x320, a bf16 folded disp0 teacher from the golden
   weights (BatchNorm statistics calibrated on synthetic scenes), a
   student from a seeded init, one 375x1242 scene replicated and the
   300x200 car: first one small step on the card against the CPU's
   plain versions (bf16 both); then 2 warm-up and 5 timed steps with
   every launch counter reset before the timed steps and read after
   (kernel D's and B's bf16 instances must launch 48 + 44 and 12 + 11
   times per step, their float32 ones never; B-bf16 10 + 10 times on the
   crop's stem and 2 + 1 at full frame): seconds per step, peak
   memory, the idle share and device ms by kernel of one step, its
   reflection-pad kernels (ms and launches: D's bf16 convs pad nothing
   but the student's weight-gradient inputs); then one untimed step with
   attack_scale 1 and one fine step, whose D launches fall by the convs
   its coarse passes skip.
11. harden: the full hardening step (BASELINE config 4) through
   HardeningTrainer.train_step at the CLI's `train-hardening --fine-tune
   --norm-type l_0` defaults (Monodepth2-18, 4 scales, 1024x320 float32,
   batch 32, frames ("0", "s"), the L0 attack with 10 steps (up to 20
   iterations) on attack batch 12, supervised + contrastive + photometric,
   Adam lr 1e-5), student and teacher from the golden weights, synthetic
   375x1242 frames ("s" shifted by 12 columns) and scenes, the 300x200
   car: first one small step on the card against the CPU's plain
   versions (the L0 iteration count and first-iteration gradients, the
   synthesis, then the training half on the CPU's batch); then 2 warm-up
   and 5 timed steps with every launch counter reset before the timed
   steps and read after: seconds per step, peak memory, each step's L0
   iterations and early break, launches against the counts predicted
   from the code and the iterations (`harden_launches`; no bf16 launch),
   finite loss terms, the student's, BatchNorm's and the SimSiam head's
   weights moved; the breakdown of a step, the L0 attack's ms an
   iteration, the idle share and device ms by kernel of one step; then
   one untimed L0 attack-eval batch (build_attack(l_0) +
   evaluate_attacks) and one untimed distillation step with adv_type
   "object_l0".
12. cli: the CLI's `train-hardening --fine-tune` defaults as they are
   (cli/main.py:594-656): HardeningTrainer.train_step with the student
   in bfloat16 (compute_dtype, the CLI's default) and the CLI's float32
   teacher, both from the golden weights with BatchNorm statistics
   calibrated on synthetic scenes (phase 10's), otherwise phase 11's
   configuration: 12a with frames ("0", "s"), 12b with ("0", "-1", "1",
   "s") (mono+stereo: the float32 pose networks; "-1" and "1" are "0"
   shifted by 8 columns and 6 rows). First one small bf16 step (frames
   ("0", "s"), seeded student) on the card against the CPU's: the
   supervised branch under phase 10's rule, with the photometric and
   contrastive branches logged beside it with the CPU's step against
   itself one ulp away; and one small float32
   mono+stereo step under phase 11's, the pose networks' gradients
   included; then for each of 12a and 12b 2 warm-up and 3 timed steps
   with the counters reset before the timed ones and read after:
   seconds per step, peak memory, L0 iterations, launches against
   `harden_launches` (every kernel instance but float32 D's input gradient
   launches in 12b), finite loss terms, every parameter and running
   statistic moved, then one profiled step (idle share, device ms by
   kernel instance); after 12a a checkpoint round trip (save_state,
   restore_state into a fresh trainer: every tensor and the generators'
   states equal, the next step's loss on the same draws within 1e-6);
   after 12b predict_pair_poses on 16 synthetic 1024x320 pairs, card
   against CPU within 1e-4, and trajectory_ates on a synthetic ground
   truth.
13. zoo: the reference's evaluation attack zoo (evaluate_depth.py:
   403-517). 13a: each attack slice 6a added (L2, APGD, whole-image PGD,
   Square, light, Gaussian, arbi, vanila, physical) at 96x320, batch 2,
   the golden weights, on the card and on the CPU's plain versions from
   the same draws: the white-box attacks' start gradient, the searches'
   winner, best cost and texture (another winner only as a logged
   near-tie), L2's texture, and the finals and metrics of one texture on
   both. 13b: the 16 presets of evaluation/presets.py at full width
   (Monodepth2-18, 1024x320 float32, eval mode, the golden weights, one
   batch of 375x1242 scenes at each preset's batch size, the 300x200
   car) through build_attack + evaluate_attacks, Square cut to
   ZOO_SQUARE_QUERIES queries and light to ZOO_LIGHT candidates, the
   counters reset before each and read after: s/batch, ms a query of the
   searches, the 8 mean metrics (finite), peak memory, launches against
   `zoo_launches`; Square and light extrapolated to their presets'
   lengths; the idle share of a shorter Square and light batch. 13c:
   evaluate_clean card against CPU (stereo or median scaling, with and
   without the flip post-process), crosscheck_matrix over the golden
   weights and a seeded init, objects_sweep over two cars, physical_eval
   with a perturbed car for the photographed patch, attack_steps_sweep
   at steps (1, 11). 13d: the distillation step with adv_type "image"
   (float32, batch 32, PGD-10, golden teacher and student): s/step, D
   and B launches as phase 9's, D's weight gradients the student's only,
   no kernel A.

Each path's kernels must launch during its own run (counters set to 0
just before it, read just after). Prints one JSON line of kernel
results, then, as the last line, {"ok": true, "device": {...}}. Needs no
network and no jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.device import require_cuda, use_f32_numerics
from depthmodelhardening_tpu_torch.attacks.random_object import _blur_hw
from depthmodelhardening_tpu_torch.evaluation import (
    clean_eval, pose_eval, sweeps,
)
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, _batch_metrics, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.evaluation.presets import EVAL_PRESETS
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    init_monodepth2, make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import _build, conv, pool, reproj, warp
from depthmodelhardening_tpu_torch.ops.padding import reflect_pad1
from depthmodelhardening_tpu_torch.ops.resize import bilinear_resize
from depthmodelhardening_tpu_torch.physics.eot import (
    ANGLE_RANGE, TRAIN_DIST_RANGE, stereo_T,
)
from depthmodelhardening_tpu_torch.training import checkpoints
from depthmodelhardening_tpu_torch.training.adv_synth import (
    make_synth_compositor, synth_tile,
)
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, DistillConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.distill import DistillTrainer
from depthmodelhardening_tpu_torch.training.hardening import (
    HardeningTrainer, StepDraws,
)
from depthmodelhardening_tpu_torch.training.selfsup import (
    compute_selfsup_losses,
)

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
GOLDEN_RTOL, GOLDEN_ATOL = 5e-4, 2e-4  # tests/test_golden_fixtures.py
# warp A1 computes as its plain version does (sy = A y + B, floor, 1 - w1,
# two products and a sum, no contraction), so it must equal it
WARP_BWD_ATOL = 1e-4
# kernel C adds and rounds as its plain version does, so both directions
# must be bit-exact (tighter than the JAX package's interpret-vs-jnp 2e-6,
# tests/test_pallas_reproj.py:38, and 1e-5 on unit cotangents backward)
REPROJ_FWD_ATOL, REPROJ_BWD_ATOL = 0.0, 0.0
# kernel D sums its products in another order than im2col + SGEMM: its
# error is held to 1e-5 of the plain output's largest magnitude
CONV_RTOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense TF32 and bf16 FLOP/s of
# the tensor cores
PEAK_BYTES_S, PEAK_F32_S, PEAK_TF32_S = 3.35e12, 67e12, 495e12
PEAK_BF16_S = 989e12
# the hardening batch's synthesis tile at 375x1242 (training/adv_synth.py)
SYNTH_TILE = synth_tile(375, 1242)
# the tile of csrc/reproj_loss.cu's fwd_kernel and bwd_grad_kernel,
# kTileH x kTileW pixels: phase 3 checks both at shapes that straddle it
REPROJ_TILE = (32, 32)
# source -> its kernels that keep every value in registers or shared
# memory: their functions (the name in their mangled symbol) must have no
# stack frame and no local memory, so nothing spills
NO_SPILL = {"reproj_loss.cu": ("fwd_kernel", "bwd_grad_kernel"),
            "vertical_resample.cu": ("vert_fwd", "vert_bwd"),
            "conv3x3.cu": ("conv3x3_bf16_mma", "conv3x3_bf16_head"),
            "maxpool3x3s2.cu": ("pool_fwd_bf16", "pool_bwd_bf16")}
CONV_KERNELS = ("conv3x3_fwd", "conv3x3_dgrad")
CONV_BF16_KERNELS = ("conv3x3_fwd_bf16", "conv3x3_dgrad_bf16")
SLICE1_KERNELS = ("vertical_resample_fwd", "vertical_resample_bwd",
                  "maxpool3x3s2_fwd", "maxpool3x3s2_bwd") + CONV_KERNELS
TRAIN_KERNELS = ("maxpool3x3s2_fwd", "maxpool3x3s2_bwd", "reproj_loss_fwd",
                 "reproj_loss_bwd_q", "reproj_loss_bwd_grad") + CONV_KERNELS
DISTILL_KERNELS = SLICE1_KERNELS


def log(msg: str) -> None:
    print(msg, flush=True)


SPIN_HZ = 2e9  # about the card's clock: cycles of torch.cuda._sleep a second


def cuda_ms(fn, reps: int = 20, queued: bool = True) -> float:
    """Median milliseconds of `fn()` on the card, by CUDA events.

    queued: before each start event the card spins (torch.cuda._sleep)
    for four times the host time `fn` takes to enqueue its work, so the
    start event fires only once the launches are queued behind it, and
    the time is the card's alone. queued=False: the events bracket the
    call as it comes, so the host time in front of each launch (a
    wrapper's checks, the ctypes call) counts too."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = int(4 * (time.perf_counter() - t0) * SPIN_HZ) + 100_000
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- phase 1 -----------------------------------------------------------------
def phase_device() -> torch.device:
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[dev.index])
    use_f32_numerics()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)} "
        f"capability {torch.cuda.get_device_capability(dev)}")
    return dev


# -- phase 2 -----------------------------------------------------------------
def resource_usage(library) -> list:
    """[(mangled kernel name, {"REG": n, "STACK": bytes, "LOCAL": bytes,
    ...})] of each function in a built library, as cuobjdump reads them."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-resource-usage", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return [(name, {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", usage)})
            for name, usage in re.findall(r"Function (\S+):\s*\n([^\n]*)",
                                          out)]


def phase_build() -> None:
    secs = _build.build_all()
    names = sorted({k.source for k in _build.KERNELS})
    log(f"build: {names} into {os.path.relpath(_build.BUILD_DIR, REPO)} "
        f"in {secs:.1f} s")
    for source in names:
        usage = resource_usage(_build.library_path(source))
        for kernel, u in usage:
            log(f"  {source} {kernel}: {u.get('REG')} registers, "
                f"{u.get('STACK')} B stack, {u.get('LOCAL')} B local")
        for name in NO_SPILL.get(source, ()):
            mine = [(k, u) for k, u in usage if name in k]
            if not mine or any(u.get("STACK", 1) or u.get("LOCAL", 1)
                               for _, u in mine):
                raise AssertionError(f"{name} of {source} is missing or "
                                     f"spills: {mine}")


# -- phase 3 -----------------------------------------------------------------
def _attack_row_maps(gen, Bn):
    """A, B (Bn, 256) of the attack's own EoT view at 1024x320 with
    256x256 tiles and the 300x200 car: distances and angles drawn from
    the attack's ranges, the geometry from the port's EoTCompositor."""
    cfg = PhysObjAttackConfig(obj_h=200, obj_w=300)
    z, a = (torch.tensor(r)[torch.randint(len(r), (Bn,), generator=gen)]
            for r in (cfg.dist_range, cfg.angle_range))
    _, A, B, _, _ = cfg.make_eot()._separable_geometry(
        z, a, cfg.scene_h, cfg.scene_w, cfg.tile_h, cfg.tile_w)
    return A, B


def _arbi_row_maps(Bn):
    """A, B (Bn, 256) of the arbi attack's finals at 1024x320 (the tiled
    pair warp a training-time final takes): the car at linspace(5, 30)
    m, beyond the eval range, so the far samples' maps are small, and
    the seeded yaws (`ArbiObjectAttack._final_za`)."""
    cfg = PhysObjAttackConfig(obj_h=200, obj_w=300)
    z = torch.linspace(5.0, 30.0, Bn)
    a = torch.from_numpy(np.random.RandomState(17).choice(
        np.arange(-30, 31, 2, dtype=np.float32), Bn, replace=True))
    _, A, B, _, _ = cfg.make_eot()._separable_geometry(
        z, a, cfg.scene_h, cfg.scene_w, cfg.tile_h, cfg.tile_w)
    return A, B


def _synth_row_maps(gen, Bn):
    """A, B (Bn, 296) of the hardening batch's synthesis: the 300x200 car
    warped at native resolution (375x1242, Monodepth2's K) into its
    248x296 tile, each sample at a training distance and yaw, through
    the identity or the 0.54 m stereo extrinsic (both eyes)."""
    th, tw = synth_tile(375, 1242)
    z, a = (torch.tensor(r)[torch.randint(len(r), (Bn,), generator=gen)]
            for r in (TRAIN_DIST_RANGE, ANGLE_RANGE))
    T = torch.where((torch.arange(Bn) % 2 == 0)[:, None, None],
                    torch.eye(4), torch.from_numpy(stereo_T(0.54, "l")))
    _, A, B, _, _ = make_synth_compositor(200, 300)._separable_geometry(
        z, a, 375, 1242, th, tw, T)
    return A, B


def _warp_inputs(gen, dev, Bn, C, OH, TH, TW, maps: str):
    inter = torch.rand((Bn, C, OH, TW), generator=gen).to(dev)
    if maps == "attack":
        A, B = _attack_row_maps(gen, Bn)
    elif maps == "arbi":
        A, B = _arbi_row_maps(Bn)
    elif maps == "synth":
        A, B = _synth_row_maps(gen, Bn)
    elif maps == "ragged":
        # every corner case of the row map: negative, zero and tiny slopes
        A = torch.empty((Bn, TW)).uniform_(-3.0, 3.0, generator=gen)
        A[:, ::5] = 0.0
        A[:, 1::7] = 1e-7
        B = torch.empty((Bn, TW)).uniform_(-OH, 2.0 * OH, generator=gen)
    else:
        # the attack's range: 200 object rows over 32..200 tile rows,
        # with columns that leave [0, OH) on both sides
        A = torch.empty((Bn, TW)).uniform_(0.9, 6.5, generator=gen)
        B = torch.empty((Bn, TW)).uniform_(-260.0, 40.0, generator=gen)
    return inter, A.to(dev), B.to(dev)


def _adjoint_in_row_order(g, A, B, oh):
    """Warp A's adjoint summed as vert_bwd sums it: each object row's
    hits g * w added one tile row at a time, y upwards, every product
    and sum rounded to float32 (the kernel is built with -fmad=false).
    A tap outside [0, oh) goes to a spare row that is dropped."""
    Bn, C, th, TW = g.shape
    d = torch.zeros((Bn, C, oh + 1, TW), dtype=g.dtype, device=g.device)
    for y in range(th):
        sy = A * float(y) + B
        k0f = torch.floor(sy)
        w1 = sy - k0f
        for kf, w in ((k0f, 1.0 - w1), (k0f + 1.0, w1)):
            idx = torch.where((kf >= 0) & (kf < oh), kf, float(oh))
            d.scatter_add_(2, idx.to(torch.int64)[:, None, None].expand(
                Bn, C, 1, TW), g[:, :, y:y + 1] * w[:, None, None])
    return d[:, :, :oh]


def _warp_work(inter, g, A, B, out, d):
    """(bytes, operations) that warp A's forward and its adjoint need on
    this run's row maps. Only a tile row with a tap in [0, OH) does
    work: the forward reads the object rows that some tap reaches and
    writes all of out; the adjoint reads g at the tile rows with a tap
    in range and writes all of d_inter; both read A and B. Operations per
    channel: the forward's two products, sum and 1 - w for each such
    row, the adjoint's product and sum for each tap in range."""
    Bn, C, OH, TW = inter.shape
    ys = torch.arange(out.shape[2], dtype=torch.float32, device=A.device)
    k0 = torch.floor(A[:, None, :] * ys[None, :, None] + B[:, None, :])
    reached = torch.zeros((Bn, OH + 1, TW), device=A.device)
    taps = 0
    hit_any = torch.zeros_like(k0, dtype=torch.bool)
    for k in (k0, k0 + 1.0):
        ok = (k >= 0) & (k < OH)
        hit_any |= ok
        taps += int(ok.sum())
        reached.scatter_(1, torch.where(ok, k, float(OH)).to(torch.int64), 1.0)
    rows = int(hit_any.sum())
    touched = int(reached[:, :OH].sum())
    return ((4 * C * touched + nbytes(A, B, out), 4 * C * rows),
            (4 * C * rows + nbytes(A, B, d), 2 * C * taps))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_: float, flops: float, tensor_cores: bool = False):
    """(ms, "bytes" | "operations"): the least time the card could take
    to read and write `nbytes_` bytes and do `flops` float32 operations,
    at its published peaks: on the CUDA cores, or with `tensor_cores` as
    three TF32 operations each (the 3xTF32 split that keeps float32
    accuracy)."""
    t_bytes = nbytes_ / PEAK_BYTES_S * 1e3
    t_ops = (3 * flops / PEAK_TF32_S if tensor_cores
             else flops / PEAK_F32_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def cudnn_on():
    """cuDNN on with TF32 still off, then `use_f32_numerics` again."""
    torch.backends.cudnn.enabled = True
    try:
        yield
    finally:
        use_f32_numerics()


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version; returns name -> result row.
    `work` is (bytes read and written, float32 operations) of the timed
    call, each input read once and each output written once, or its
    bound already summed over several calls, (ms, "bytes" | "operations").
    """
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    def row(kernel, err, ms, plain_ms, library_ms, work, host_ms=None,
            label=None):
        """`ms`: the kernel's time on the card alone, and `host_ms` with
        the host time in front of each launch (queued=False); or `ms` is
        the kernel's call, and both are timed here. With a `label` the
        row is logged under it and kept out of the JSON line (which
        holds one row a kernel)."""
        if callable(ms):
            host_ms, ms = cuda_ms(ms, queued=False), cuda_ms(ms)
        bound_ms, bound_by = work if isinstance(work[1], str) else \
            bound(*work)
        entry = dict(
            name=kernel.name, route="cuda", source=kernel.source_path,
            replaces=kernel.replaces, max_abs_err=err, ms=ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms)
        if label is None:
            rows[kernel.name] = entry
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  {kernel.name}{label or ''}: max|kernel-plain| {err:.3e}  "
            f"kernel {ms:.4f} ms ({host_ms:.4f} with host time)  plain "
            f"{plain_ms:.4f} ms  library {lib}  bound {bound_ms:.4f} ms "
            f"({bound_by})")

    # warp A: random slopes over the attack's range, ragged maps with
    # every corner case (an odd TW: A1's scalar stores), ragged strips
    # (TH = 250 is not a multiple of the 4 rows of A1's block, TW = 200
    # not of its 64 columns), and the attack's own row maps at the attack
    # eval's batch (the row's times) and the distillation step's; the
    # forward equal to its plain version, the adjoint also bit for bit
    # against the sum in the kernel's order
    for label, shape, maps in (
            ("random maps", (12, 4, 200, 256, 256), "random"),
            ("ragged", (3, 5, 37, 45, 53), "ragged"),
            ("ragged strips", (4, 4, 200, 250, 200), "random"),
            ("attack maps", (12, 4, 200, 256, 256), "attack"),
            ("attack maps, distillation", (32, 4, 200, 256, 256), "attack"),
            ("arbi finals' maps, out to 30 m", (32, 7, 200, 256, 256),
             "arbi"),
            ("synthesis maps, the pair", (32, 7, 200) + SYNTH_TILE, "synth"),
            ("synthesis maps, the other eye", (32, 4, 200) + SYNTH_TILE,
             "synth")):
        Bn, C, OH, TH, TW = shape
        inter, A, B = _warp_inputs(gen, dev, Bn, C, OH, TH, TW, maps)
        g = torch.randn((Bn, C, TH, TW), generator=gen).to(dev)
        out_k = warp.vertical_resample_fwd_cuda(inter, A, B, TH)
        out_p = warp.vertical_resample_plain(inter, A, B, TH)
        d_k = warp.vertical_resample_bwd_cuda(g, A, B, OH)
        d_p = warp.vertical_resample_adjoint_plain(g, A, B, OH)
        d_seq = _adjoint_in_row_order(g, A, B, OH)
        torch.cuda.synchronize()
        e_f = float((out_k - out_p).abs().max())
        e_b = float((d_k - d_p).abs().max())
        fwd_equal = torch.equal(out_k, out_p)
        in_order = torch.equal(d_k, d_seq)
        log(f"warp {label} {shape}: fwd err {e_f:.3e}, equal {fwd_equal}; "
            f"adjoint err {e_b:.3e} (atol {WARP_BWD_ATOL}), bit-exact with "
            f"the row-order sum {in_order}")
        if not (fwd_equal and e_b <= WARP_BWD_ATOL and in_order):
            raise AssertionError(f"warp kernel disagrees at {shape}")
        if label.startswith("ragged"):
            continue
        work_f, work_b = _warp_work(inter, g, A, B, out_k, d_k)

        def fwd():
            return warp.vertical_resample_fwd_cuda(inter, A, B, TH)

        def bwd():
            return warp.vertical_resample_bwd_cuda(g, A, B, OH)

        if label != "attack maps":
            log(f"  {label} {shape}: vertical_resample_fwd "
                f"{cuda_ms(fwd):.4f} ms ({cuda_ms(fwd, queued=False):.4f} "
                f"with host time; bound {bound(*work_f)[0]:.4f}), "
                f"vertical_resample_bwd {cuda_ms(bwd):.4f} ms "
                f"({cuda_ms(bwd, queued=False):.4f} with host time; bound "
                f"{bound(*work_b)[0]:.4f})")
        else:
            # no library call: A's two taps with their own validity
            # masks are not F.grid_sample's edge rule
            row(warp.FWD, e_f, fwd,
                cuda_ms(lambda: warp.vertical_resample_plain(
                    inter, A, B, TH)), None, work_f)
            row(warp.BWD, e_b, bwd,
                cuda_ms(lambda: warp.vertical_resample_adjoint_plain(
                    g, A, B, OH)), None, work_b)

    # the stem pool sees relu outputs: many exact zeros, so ties are the
    # rule and the equality routing must agree with the plain version; at
    # the attack's and the distillation step's shapes, and at ragged ones
    # that straddle B2's 16 x 64-window tiles, with rows of whole 16-byte
    # groups (W % 4 = 0) and without
    for shape in ((12, 64, 160, 512), (32, 64, 160, 512), (2, 3, 17, 23),
                  (1, 2, 66, 130), (1, 2, 67, 132)):
        x = torch.relu(torch.randn(shape, generator=gen)).to(dev)
        y_k = pool.maxpool3x3s2_fwd_cuda(x)
        y_p = pool.maxpool3x3s2_plain(x)
        g = torch.randn(y_p.shape, generator=gen).to(dev)
        dx_k = pool.maxpool3x3s2_bwd_cuda(x, g)
        dx_p = pool.maxpool3x3s2_backward_plain(x, g)
        torch.cuda.synchronize()
        e_f = float((y_k - y_p).abs().max())
        e_b = float((dx_k - dx_p).abs().max())
        exact = torch.equal(y_k, y_p) and torch.equal(dx_k, dx_p)
        log(f"pool {shape}: fwd err {e_f:.3e}, bwd err {e_b:.3e}, "
            f"bit-exact {exact}")
        if not exact:
            raise AssertionError(f"pool kernel is not bit-exact at {shape}")
        if shape[0] == 12:
            # library: F.max_pool2d and its autograd backward (which
            # routes a tie to one input, B2 to all). Operations: 8 max
            # per window; backward 8 max, 9 tests, 9 sums per window
            _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
            row(pool.FWD, e_f, lambda: pool.maxpool3x3s2_fwd_cuda(x),
                cuda_ms(lambda: pool.maxpool3x3s2_plain(x)),
                cuda_ms(lambda: F.max_pool2d(x, 3, 2, 1)),
                (nbytes(x, y_k), 8 * y_k.numel()))
            row(pool.BWD, e_b, lambda: pool.maxpool3x3s2_bwd_cuda(x, g),
                cuda_ms(lambda: pool.maxpool3x3s2_backward_plain(x, g)),
                cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)),
                (nbytes(x, g, dx_k), 26 * g.numel()))

    check_pool_nan(dev, gen)

    # kernel C at the training step's shape, a ragged one, H or W = 2
    # (reflect edges), and shapes that straddle the tiles of its forward
    # and bwd_grad (one row and column past them, W % 4 = 0 and not, a
    # single row or column); y equals x on a band of rows and on
    # scattered pixels, so the clip's 0.5 and |.|''s +1 tie rules are
    # exercised
    th, tw = REPROJ_TILE
    for shape in ((32, 3, 320, 1024), (3, 3, 37, 53), (2, 3, 2, 41),
                  (2, 3, 23, 2), (2, 3, th + 1, tw + 1),
                  (1, 3, 2 * th + 1, 4 * tw + 4), (2, 3, th // 2 + 1, tw - 2),
                  (1, 3, 1, tw + 5), (1, 3, th + 5, 1)):
        x, y = _reproj_inputs(gen, dev, shape)
        g = torch.randn((shape[0],) + shape[2:], generator=gen).to(dev)
        out_k = reproj.reproj_loss_fwd_cuda(x, y)
        out_p = reproj.reproj_loss_plain(x, y)
        dx_k, dy_k = reproj.reproj_loss_bwd_cuda(x, y, g)
        dx_p, dy_p = reproj.reproj_loss_backward_plain(x, y, g)
        torch.cuda.synchronize()
        e_f = float((out_k - out_p).abs().max())
        e_b = max(float((dx_k - dx_p).abs().max()),
                  float((dy_k - dy_p).abs().max()))
        log(f"reproj {shape}: fwd err {e_f:.3e} (atol {REPROJ_FWD_ATOL}), "
            f"bwd err {e_b:.3e} (atol {REPROJ_BWD_ATOL}), ties "
            f"{int((x == y).sum())} of {x.numel()}")
        if not (e_f <= REPROJ_FWD_ATOL and e_b <= REPROJ_BWD_ATOL):
            raise AssertionError(f"reproj kernel disagrees at {shape}")
        if shape[0] == 32:
            B, C, H, W = shape
            q = reproj.reproj_loss_bwd_q_plain(x, y, g)
            dx = torch.empty_like(x)
            stream = _build.stream_handle(x)
            # no library call computes SSIM. Operations per pixel and
            # channel, about: 9 taps x (5 sums + 3 products) of the
            # moments, the SSIM quotient, clip and L1 (100 forward); the
            # moment derivatives (120); the pool and pad adjoints (72)
            row(reproj.FWD, e_f, lambda: reproj.reproj_loss_fwd_cuda(x, y),
                cuda_ms(lambda: reproj.reproj_loss_plain(x, y), reps=5),
                None, (nbytes(x, y, out_k), 100 * x.numel()))
            row(reproj.BWD_Q, e_b, lambda: reproj.BWD_Q.launch(
                    x.data_ptr(), y.data_ptr(), g.data_ptr(), q.data_ptr(),
                    B, C, H, W, stream),
                cuda_ms(lambda: reproj.reproj_loss_bwd_q_plain(x, y, g),
                        reps=5), None, (nbytes(x, y, g, q), 120 * x.numel()))
            row(reproj.BWD_GRAD, e_b, lambda: reproj.BWD_GRAD.launch(
                    x.data_ptr(), y.data_ptr(), g.data_ptr(), q.data_ptr(),
                    dx.data_ptr(), 0, B, C, H, W, stream),
                cuda_ms(lambda: reproj.reproj_loss_grad_from_q_plain(
                    x, y, g, q, need_dy=False), reps=5), None,
                (nbytes(x, y, g, q, dx), 72 * x.numel()))
            log(f"  (backward rows: d_pred only, no d_target, as the "
                f"training step asks)")
    phase_conv_kernels(dev, gen, row)
    phase_bf16_kernels(dev, gen, row)
    return rows


# the convs that kernel D takes on the distillation step's scale-0 path
# at 1024x320: (name, Cin, Co, H, W of the output)
CONV_SHAPES = (("upconv_1_0", 64, 32, 80, 256),
               ("upconv_0_0", 32, 16, 160, 512),
               ("upconv_0_1", 16, 16, 320, 1024),
               ("dispconv_0", 16, 1, 320, 1024))
CONV_BATCH = 32
# checked only: shapes that miss every tile edge (the tensor-core
# kernel's 8 or 16 rows x 32 columns x 8-channel K chunks and N tiles;
# one channel in or out takes the CUDA-core kernel one way), and
# upconv_0_1 on bench.py's 320x256 attack crop
CONV_RAGGED = tuple((f"ragged {cin}->{co}", 2, cin, co, 37, 53)
                    for cin in (1, 3, 13, 64) for co in (1, 3, 13, 64))
CONV_CROP = ("crop upconv_0_1", CONV_BATCH, 16, 16, 256, 320)


def _conv_inputs(gen, dev, B, cin, co, h, w):
    xp = torch.rand((B, cin, h + 2, w + 2), generator=gen).to(dev)
    wt = (torch.randn((co, cin, 3, 3), generator=gen)
          / (3.0 * cin ** 0.5)).to(dev)
    b = (0.1 * torch.randn((co,), generator=gen)).to(dev)
    g = torch.randn((B, co, h, w), generator=gen).to(dev)
    return xp, wt, b, g


def check_conv(name, xp, wt, b, g, x=None) -> dict:
    """Kernel D against its plain version: forward, forward + bias + ELU
    and input gradient; the worst error of each entry point. float32:
    within CONV_RTOL of the plain output's largest magnitude. bf16 (the
    plain version is float32 arithmetic on the bf16 operands, rounded
    once): every element within one bf16 ulp of the plain one, plus
    CONV_RTOL of that largest magnitude where the float32 sum cancels to
    near 0 (the two sum in another order), in zero-border mode (xp in,
    d xp out) and, given the unpadded x (xp = reflect_pad1(x)), in
    reflect mode (x in, dx out)."""
    bf16 = xp.dtype == torch.bfloat16
    names = CONV_BF16_KERNELS if bf16 else CONV_KERNELS
    pairs = {
        "fwd": (lambda: conv.conv3x3_valid_cuda(xp, wt),
                lambda: conv.conv3x3_valid_plain(xp, wt)),
        "fwd bias+elu": (lambda: conv.conv3x3_valid_cuda(xp, wt, b, True),
                         lambda: conv.conv3x3_valid_plain(xp, wt, b, True)),
        "dgrad": (lambda: conv.conv3x3_dgrad_cuda(g, wt),
                  lambda: conv.conv3x3_dgrad_plain(g, wt)),
    }
    if x is not None:
        pairs.update({
            "reflect fwd": (lambda: conv.conv3x3_reflect_cuda(x, wt),
                            lambda: conv.conv3x3_reflect_plain(x, wt)),
            "reflect fwd bias+elu": (
                lambda: conv.conv3x3_reflect_cuda(x, wt, b, True),
                lambda: conv.conv3x3_reflect_plain(x, wt, b, True)),
            "reflect dgrad": (
                lambda: conv.conv3x3_dgrad_reflect_cuda(g, wt),
                lambda: conv.conv3x3_dgrad_reflect_plain(g, wt)),
        })
    errs, msg = {n: 0.0 for n in names}, []
    for label, (kernel_fn, plain_fn) in pairs.items():
        out_k, out_p = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if out_k.dtype != xp.dtype:
            raise AssertionError(f"conv {label} returned {out_k.dtype}")
        diff = (out_k.float() - out_p.float()).abs()
        err = float(diff.max())
        tol = CONV_RTOL * float(out_p.float().abs().max())
        if bf16:
            ulp = bf16_ulp(out_p)
            over = int((diff > ulp + tol).sum())
            msg.append(f"{label} max {err:.3e}, {int((diff > 0).sum())} of "
                       f"{diff.numel()} differ, {int((diff > ulp).sum())} "
                       f"by more than an ulp (slack {tol:.1e})")
        else:
            over = int(not err <= tol)
            msg.append(f"{label} err {err:.3e} (tol {tol:.3e})")
        if over:
            raise AssertionError(f"conv kernel {label} disagrees at {name}: "
                                 f"{err} > {tol} ({over} elements)")
        which = names[1] if label.endswith("dgrad") else names[0]
        errs[which] = max(errs[which], err)
        del out_k, out_p, diff
    B, cin, co = xp.shape[0], xp.shape[1], wt.shape[0]
    kind = "conv bf16" if bf16 else "conv"
    log(f"{kind} {name} ({B}, {cin}->{co}, {g.shape[2]}x{g.shape[3]}): "
        + ", ".join(msg))
    return errs


def phase_conv_kernels(dev, gen, row) -> None:
    """Kernel D at the four convs of one decoder pass, at ragged shapes
    and at the attack crop: each against its plain version (`check_conv`).
    A row's times and work are those of the whole pass (the upconvs with
    bias + ELU, the head with a bias, as the decoder runs them); the
    library call is F.conv2d (forward, without the ELU) and its input
    gradient `conv2d_input`, timed with cuDNN off (as the port runs) and
    on with TF32 off (the row's `library_ms`). Each conv's bound is given
    twice: float32 operations on the CUDA cores, and on the tensor cores
    as 3xTF32 (the row's `bound_ms`: the least time at float32
    accuracy)."""
    for name, *shape in CONV_RAGGED + (CONV_CROP,):
        check_conv(name, *_conv_inputs(gen, dev, *shape))
    tot = {n: dict(err=0.0, ms=0.0, host_ms=0.0, plain_ms=0.0, lib_off=0.0,
                   lib_on=0.0, f32=0.0, tc=0.0, bytes=0.0, operations=0.0)
           for n in CONV_KERNELS}
    for name, cin, co, h, w in CONV_SHAPES:
        xp, wt, b, g = _conv_inputs(gen, dev, CONV_BATCH, cin, co, h, w)
        for which, err in check_conv(name, xp, wt, b, g).items():
            tot[which]["err"] = max(tot[which]["err"], err)
        elu = co > 1
        timed = {  # the forward's output has g's shape
            "conv3x3_fwd": (
                lambda: conv.conv3x3_valid_cuda(xp, wt, b, elu),
                lambda: conv.conv3x3_valid_plain(xp, wt, b, elu),
                lambda: F.conv2d(xp, wt, b),
                (nbytes(xp, wt, b, g),
                 2 * g.numel() * cin * 9 + (3 if elu else 1) * g.numel())),
            "conv3x3_dgrad": (
                lambda: conv.conv3x3_dgrad_cuda(g, wt),
                lambda: conv.conv3x3_dgrad_plain(g, wt),
                lambda: torch.nn.grad.conv2d_input(xp.shape, wt, g),
                (nbytes(g, wt, xp), 2 * g.numel() * cin * 9)),
        }
        for which, (kernel_fn, plain_fn, lib_fn, work) in timed.items():
            t = tot[which]
            k_ms = cuda_ms(kernel_fn, reps=10)
            h_ms = cuda_ms(kernel_fn, reps=10, queued=False)
            p_ms = cuda_ms(plain_fn, reps=10)
            off_ms = cuda_ms(lib_fn, reps=10)
            with cudnn_on():
                on_ms = cuda_ms(lib_fn, reps=10)
            f32_ms, f32_by = bound(*work)
            tc_ms, tc_by = bound(*work, tensor_cores=True)
            log(f"  {which} {name}: kernel {k_ms:.4f} ms ({h_ms:.4f} with "
                f"host time), plain {p_ms:.4f}, "
                f"library cuDNN off {off_ms:.4f}, cuDNN on (TF32 off) "
                f"{on_ms:.4f}, bound CUDA cores {f32_ms:.4f} ({f32_by}), "
                f"tensor cores {tc_ms:.4f} ({tc_by})")
            t["ms"] += k_ms
            t["host_ms"] += h_ms
            t["plain_ms"] += p_ms
            t["lib_off"] += off_ms
            t["lib_on"] += on_ms
            t["f32"] += f32_ms
            t["tc"] += tc_ms
            t[tc_by] += tc_ms
        del xp, g
    for which, kernel in (("conv3x3_fwd", conv.FWD),
                          ("conv3x3_dgrad", conv.DGRAD)):
        t = tot[which]
        log(f"  {which}, one decoder pass ({len(CONV_SHAPES)} convs): "
            f"kernel {t['ms']:.4f} ms ({t['host_ms']:.4f} with host time), "
            f"library cuDNN off {t['lib_off']:.4f}, "
            f"cuDNN on (TF32 off) {t['lib_on']:.4f}, bound CUDA cores "
            f"{t['f32']:.4f}, tensor cores {t['tc']:.4f} "
            f"({t['tc'] / t['ms']:.4f} of the kernel's time)")
        # the pass's bound: the sum of its convs' tensor-core bounds,
        # named after the kind that bounds most of it
        row(kernel, t["err"], t["ms"], t["plain_ms"], t["lib_on"],
            (t["tc"], max(("bytes", "operations"), key=t.get)),
            host_ms=t["host_ms"])


# the bench configuration's attack passes: kernel D's convs of the
# scale-0 path on the 320x256 crop at batch 32, and the stem pool there
CONV_CROP_SHAPES = (("upconv_1_0", 64, 32, 64, 80),
                    ("upconv_0_0", 32, 16, 128, 160),
                    ("upconv_0_1", 16, 16, 256, 320),
                    ("dispconv_0", 16, 1, 256, 320))
POOL_CROP_SHAPE = (CONV_BATCH, 64, 128, 160)
POOL_FULL_SHAPE = (CONV_BATCH, 64, 160, 512)  # the teacher's and student's
POOL_BF16_TIMED = (POOL_CROP_SHAPE, POOL_FULL_SHAPE)
# (shape, 16-byte aligned, sparse) of the bf16 pool's checks: the bench
# step's two stems; ragged shapes for the row strips of both kernels (8
# columns a thread; the backward's 2 window rows): W % 8 != 0 with W even
# and odd (the element-wise path), W % 16 != 0 with W % 8 == 0 (Wo % 8 !=
# 0, and Wo % 4 != 0), ragged rows; H and W in {1, 2, 3}; views one
# element past a 16-byte boundary (the element-wise path on any width);
# sparse (`_pool_bf16_inputs`): ties of all four covering windows are
# common and the cotangents are +-1 and +-2^25, so the float32 sum's
# order shows in the bits
POOL_BF16_CHECKS = tuple((s, True, False) for s in (
    POOL_CROP_SHAPE, POOL_FULL_SHAPE, (2, 3, 17, 23), (1, 2, 66, 130),
    (1, 2, 67, 132), (2, 3, 34, 94), (2, 3, 35, 95), (1, 4, 40, 208),
    (1, 4, 45, 200), (1, 4, 44, 232), (2, 3, 3, 16), (2, 3, 1, 32))) + tuple(
    ((2, 3, h, w), True, False) for h in (1, 2, 3) for w in (1, 2, 3)) + tuple(
    (s, False, False) for s in (POOL_CROP_SHAPE, (2, 3, 34, 94),
                                (1, 4, 40, 208))) + (
    (POOL_CROP_SHAPE, True, True), ((2, 3, 35, 95), True, True))


# the bf16 checks' further shapes: channels of CONV_RAGGED at W = 48 (W %
# 8 == 0: the 16-byte staging path of the reflect mode and of the input
# gradients; W = 53 takes the scalar one) and at W = 46 (xp's width 48:
# the zero-border forward's 16-byte path), and maps with H or W in
# {1, 2, 3} (reflection where a side has 1 or 2 pixels)
CONV_BF16_RAGGED = tuple(
    (f"ragged {cin}->{co} W%8=0", 2, cin, co, 37, 48)
    for cin, co in ((1, 16), (3, 13), (13, 64), (16, 1), (16, 16), (32, 64),
                    (64, 3), (64, 32))) + tuple(
    (f"ragged {cin}->{co} (W+2)%8=0", 2, cin, co, 37, 46)
    for cin, co in ((16, 16), (16, 1), (64, 32))) + tuple(
    (f"small {cin}->{co}", 2, cin, co, h, w)
    for cin, co in ((16, 16), (16, 1), (1, 16), (32, 64))
    for h, w in ((1, 1), (1, 8), (2, 3), (3, 2), (3, 16), (2, 24)))


def _conv_bf16_inputs(gen, dev, B, cin, co, h, w):
    """x (B, Cin, H, W), w, b and g (B, Co, H, W) in bf16, at the float32
    inputs' scales."""
    x = torch.rand((B, cin, h, w), generator=gen).to(dev)
    wt = (torch.randn((co, cin, 3, 3), generator=gen)
          / (3.0 * cin ** 0.5)).to(dev)
    b = (0.1 * torch.randn((co,), generator=gen)).to(dev)
    g = torch.randn((B, co, h, w), generator=gen).to(dev)
    return [t.bfloat16() for t in (x, wt, b, g)]


def check_conv_bf16(name, x, wt, b, g) -> dict:
    """`check_conv` in bf16, in both modes, on x and its reflect pad."""
    return check_conv(name, reflect_pad1(x), wt, b, g, x=x)


def bf16_ulp(t):
    """One bf16 ulp at |t| (2^(e - 7) for 2^e <= |t| < 2^(e + 1))."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bound_bf16(nbytes_: float, flops: float):
    """(ms, "bytes" | "operations") at the card's HBM rate and its dense
    bf16 tensor-core rate."""
    t_bytes = nbytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bf16_kernels(dev, gen, row) -> None:
    """The bf16 instances of kernels D and B at the bench configuration's
    shapes. D: checked (`check_conv_bf16`, reflect and zero-border mode)
    at the decoder's four scale-0 convs at 1024x320 (the teacher's and the
    student's passes), at the 320x256 crop's (the attack's), at the
    ragged shapes and at CONV_BF16_RAGGED; its rows time one decoder pass
    on the crop in reflect mode (the pad folded in), against the same
    run's "before" (reflect_pad1 + the zero-border launch; the
    zero-border input gradient + the pad's backward), which each
    direction of the pass must beat, against the plain version and
    against F.conv2d / conv2d_input on xp in bf16 with cuDNN on (the
    library call), bound by the bytes of x, w, b and out (g, w and dx)
    over 3.35 TB/s or operations over 989 TFLOP/s, the larger, summed over
    the pass. B1 and B2: equal to their plain versions (torch.equal: the
    max is exact; B2 sums in float32 in the plain version's order and
    rounds once) at the stem's shapes of the crop and of the full frame
    and at ragged ones; timed on the crop."""
    for name, *shape in CONV_RAGGED + CONV_BF16_RAGGED:
        check_conv_bf16(name, *_conv_bf16_inputs(gen, dev, *shape))
    for name, cin, co, h, w in CONV_SHAPES:
        check_conv_bf16(f"{name} 1024x320", *_conv_bf16_inputs(
            gen, dev, CONV_BATCH, cin, co, h, w))
    tot = {n: dict(err=0.0, ms=0.0, host_ms=0.0, plain_ms=0.0, lib=0.0,
                   before=0.0, bytes=0.0, operations=0.0)
           for n in CONV_BF16_KERNELS}
    for name, cin, co, h, w in CONV_CROP_SHAPES:
        x, wt, b, g = _conv_bf16_inputs(gen, dev, CONV_BATCH, cin, co, h, w)
        for which, err in check_conv_bf16(f"{name} crop", x, wt, b,
                                          g).items():
            tot[which]["err"] = max(tot[which]["err"], err)
        xp = reflect_pad1(x)
        elu = co > 1
        timed = {  # the forward's output has g's shape, dx x's
            "conv3x3_fwd_bf16": (
                lambda: conv.conv3x3_reflect_cuda(x, wt, b, elu),
                lambda: conv.conv3x3_valid_cuda(reflect_pad1(x), wt, b, elu),
                lambda: conv.conv3x3_reflect_plain(x, wt, b, elu),
                lambda: F.conv2d(xp, wt, b),
                (nbytes(x, wt, b, g),
                 2 * g.numel() * cin * 9 + (3 if elu else 1) * g.numel())),
            "conv3x3_dgrad_bf16": (
                lambda: conv.conv3x3_dgrad_reflect_cuda(g, wt),
                lambda: torch.ops.aten.reflection_pad2d_backward(
                    conv.conv3x3_dgrad_cuda(g, wt), x, [1, 1, 1, 1]),
                lambda: conv.conv3x3_dgrad_reflect_plain(g, wt),
                lambda: torch.nn.grad.conv2d_input(xp.shape, wt, g),
                (nbytes(g, wt, x), 2 * g.numel() * cin * 9)),
        }
        for which, (kernel_fn, before_fn, plain_fn, lib_fn,
                    work) in timed.items():
            t = tot[which]
            k_ms = cuda_ms(kernel_fn, reps=10)
            h_ms = cuda_ms(kernel_fn, reps=10, queued=False)
            before_ms = cuda_ms(before_fn, reps=10)
            p_ms = cuda_ms(plain_fn, reps=10)
            with cudnn_on():
                lib_ms = cuda_ms(lib_fn, reps=10)
            b_ms, b_by = bound_bf16(*work)
            log(f"  {which} {name} crop: kernel {k_ms:.4f} ms ({h_ms:.4f} "
                f"with host time), before (pad + zero-border launch) "
                f"{before_ms:.4f}, plain {p_ms:.4f}, library (cuDNN on, "
                f"bf16, on xp) {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
            t["ms"] += k_ms
            t["host_ms"] += h_ms
            t["before"] += before_ms
            t["plain_ms"] += p_ms
            t["lib"] += lib_ms
            t[b_by] += b_ms
        del x, xp, g
    for which, kernel in (("conv3x3_fwd_bf16", conv.FWD_BF16),
                          ("conv3x3_dgrad_bf16", conv.DGRAD_BF16)):
        t = tot[which]
        bound_ms = t["bytes"] + t["operations"]
        log(f"  {which}, one decoder pass on the crop "
            f"({len(CONV_CROP_SHAPES)} convs, the pad folded in): kernel "
            f"{t['ms']:.4f} ms, before (pad + zero-border launch) "
            f"{t['before']:.4f}, library {t['lib']:.4f}, bound "
            f"{bound_ms:.4f} ({bound_ms / t['ms']:.4f} of the kernel's "
            f"time)")
        if not t["ms"] < t["before"]:
            raise AssertionError(f"{which}: the fused pass is not faster "
                                 f"than the pad and the zero-border launch")
        row(kernel, t["err"], t["ms"], t["plain_ms"], t["lib"],
            (bound_ms, max(("bytes", "operations"), key=t.get)),
            host_ms=t["host_ms"])

    for shape, aligned, sparse in POOL_BF16_CHECKS:
        x, g = _pool_bf16_inputs(gen, dev, shape, aligned, sparse)
        y_p = pool.maxpool3x3s2_plain(x)
        y_k = pool.maxpool3x3s2_fwd_cuda(x)
        dx_k = pool.maxpool3x3s2_bwd_cuda(x, g)
        dx_p = pool.maxpool3x3s2_backward_plain(x, g)
        torch.cuda.synchronize()
        e_f = float((y_k.float() - y_p.float()).abs().max())
        e_b = float((dx_k.float() - dx_p.float()).abs().max())
        exact = torch.equal(y_k, y_p) and torch.equal(dx_k, dx_p)
        log(f"pool bf16 {shape}{'' if aligned else ', not 16-byte aligned'}"
            f"{', sparse' if sparse else ''}: fwd err {e_f:.3e}, bwd err "
            f"{e_b:.3e}, bit-exact {exact}")
        if not exact:
            raise AssertionError(f"bf16 pool kernel is not bit-exact at "
                                 f"{shape}, aligned {aligned}, sparse "
                                 f"{sparse}")
        if shape in POOL_BF16_TIMED and aligned and not sparse:
            # the row: the crop's stem; the full frame's logged beside it
            label = None if shape == POOL_CROP_SHAPE else f" {shape}"
            _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
            row(pool.FWD_BF16, e_f,
                lambda: pool.maxpool3x3s2_fwd_cuda(x),
                cuda_ms(lambda: pool.maxpool3x3s2_plain(x)),
                cuda_ms(lambda: F.max_pool2d(x, 3, 2, 1)),
                bound(nbytes(x, y_k), 8 * y_k.numel()), label=label)
            row(pool.BWD_BF16, e_b,
                lambda: pool.maxpool3x3s2_bwd_cuda(x, g),
                cuda_ms(lambda: pool.maxpool3x3s2_backward_plain(x, g)),
                cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)),
                bound(nbytes(x, g, dx_k), 26 * g.numel()), label=label)
        del x, g, y_k, y_p, dx_k, dx_p


# (dtype, shape, 16-byte aligned) of the pool's NaN checks: the attack's
# stem in float32, the crop's in bf16, ragged shapes for the tiles and
# strips, one not 16-byte aligned, a 3x3 map
POOL_NAN_CHECKS = (
    (torch.float32, (12, 64, 160, 512), True),
    (torch.float32, (2, 3, 17, 23), True), (torch.float32, (1, 2, 67, 132),
                                            True),
    (torch.bfloat16, POOL_CROP_SHAPE, True),
    (torch.bfloat16, (2, 3, 35, 95), True),
    (torch.bfloat16, (2, 3, 35, 95), False),
    (torch.bfloat16, (2, 3, 3, 3), True))


def _with_nans(x, gen):
    """x with NaN inside a window (an even row and column: one covering
    window), on a window's edge (odd, odd: four), over a whole 3x3
    window, and at 0.1% of the elements."""
    x = x.clone()
    H, W = x.shape[2:]
    nan = float("nan")
    x[:, :, min(4, H - 1), min(6, W - 1)] = nan
    x[:, :, min(9, H - 1), min(13, W - 1)] = nan
    x[:, :, 15:18, 21:24] = nan
    x[torch.rand(x.shape, generator=gen).to(x.device) < 1e-3] = nan
    return x


def check_pool_nan(dev, gen) -> None:
    """Every pool kernel keeps a NaN as the plain version (amax) does: the
    forward NaN exactly where the plain version's is and equal elsewhere;
    the backward, where a window's max is NaN and routes nowhere, equal
    to the plain version (torch.equal)."""
    for dtype, shape, aligned in POOL_NAN_CHECKS:
        x = _with_nans(torch.relu(torch.randn(shape, generator=gen)), gen)
        g = torch.randn(shape[:2] + (pool.pooled_size(shape[2]),
                                     pool.pooled_size(shape[3])),
                        generator=gen)
        x, g = x.to(dev, dtype), g.to(dev, dtype)
        if not aligned:
            x, g = _unaligned(x), _unaligned(g)
        y_k = pool.maxpool3x3s2_fwd_cuda(x)
        y_p = pool.maxpool3x3s2_plain(x)
        dx_k = pool.maxpool3x3s2_bwd_cuda(x, g)
        dx_p = pool.maxpool3x3s2_backward_plain(x, g)
        torch.cuda.synchronize()
        n_nan = int(torch.isnan(y_p).sum())
        fwd = (torch.equal(torch.isnan(y_k), torch.isnan(y_p))
               and torch.equal(y_k.nan_to_num(0.0), y_p.nan_to_num(0.0)))
        bwd = torch.equal(dx_k, dx_p)
        log(f"pool NaN {str(dtype)[6:]} {shape}"
            f"{'' if aligned else ', not 16-byte aligned'}: {n_nan} NaN "
            f"windows, forward NaN kept and equal {fwd}, backward equal "
            f"{bwd}")
        if not (fwd and bwd and n_nan > 0):
            raise AssertionError(f"the {dtype} pool kernels do not keep NaN "
                                 f"as the plain version at {shape}")


def _pool_bf16_inputs(gen, dev, shape, aligned=True, sparse=False):
    """x and g in bf16 for the pool: x relu outputs (ties at 0), or with
    `sparse` relu(randn - 1.5) (93% zeros) and g of +-1 and +-2^25 (1 +
    2^25 rounds to 2^25 in float32: a sum of four absorbs or cancels by
    its order); with `aligned` False both start one element past a
    16-byte boundary."""
    x = torch.randn(shape, generator=gen)
    x = torch.relu(x - 1.5 if sparse else x)
    g = torch.randn(shape[:2] + (pool.pooled_size(shape[2]),
                                 pool.pooled_size(shape[3])), generator=gen)
    if sparse:
        g = torch.sign(g) * torch.exp2(25.0 * torch.randint(
            0, 2, g.shape, generator=gen).float())
    x, g = x.to(dev).bfloat16(), g.to(dev).bfloat16()
    return (x, g) if aligned else (_unaligned(x), _unaligned(g))


def _unaligned(t):
    """A contiguous copy of t whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _reproj_inputs(gen, dev, shape):
    x = torch.rand(shape, generator=gen)
    y = torch.rand(shape, generator=gen)
    H = shape[2]
    band = slice(H // 4, H // 4 + max(3, H // 3))
    y[:, :, band] = x[:, :, band]
    eq = torch.rand(shape, generator=gen) < 0.05
    y[eq] = x[eq]
    return x.to(dev), y.to(dev)


# -- phase 4 -----------------------------------------------------------------
def _golden_weights():
    """The deterministic reference-layout state dicts (numpy only)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import golden_common

    return golden_common, load_reference_state_dict(
        golden_common.resnet18_encoder_state_dict(seed=SEED),
        golden_common.depth_decoder_state_dict(seed=SEED))


def phase_golden(dev) -> None:
    gc, sd = _golden_weights()
    data = np.load(os.path.join(REPO, "tests", "golden",
                                "monodepth2_rand.npz"))
    model = make_monodepth2()
    model.load_state_dict(sd)
    model = model.to(dev).eval()
    x = torch.from_numpy(gc.golden_input(int(data["input_seed"]))).to(dev)
    with torch.no_grad():
        feats, disps = model.features_and_disps(x)
    worst = 0.0
    for i, f in enumerate(feats):
        got = f.permute(0, 2, 3, 1).cpu().numpy()[gc.FEAT_CROP]
        np.testing.assert_allclose(got, data[f"feat{i}_crop"],
                                   rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL,
                                   err_msg=f"feat{i}")
        worst = max(worst, float(np.abs(got - data[f"feat{i}_crop"]).max()))
    for sc in range(4):
        got = disps[("disp", sc)].permute(0, 2, 3, 1).cpu().numpy()
        np.testing.assert_allclose(got, data[f"disp{sc}"],
                                   atol=GOLDEN_ATOL, err_msg=f"disp{sc}")
        worst = max(worst, float(np.abs(got - data[f"disp{sc}"]).max()))
    log(f"golden: Monodepth2-18 96x320 matches monodepth2_rand.npz "
        f"(rtol {GOLDEN_RTOL}, atol {GOLDEN_ATOL}); max abs err {worst:.3e}")


# -- phase 5 -----------------------------------------------------------------
CFG = AttackEvalConfig(norm_type="l_inf", epsilon=0.1, alpha=0.005, step=10,
                       batch_size=12, eval_count=2)


def phase_slice(dev):
    """The attack-eval slice at full width; returns (launches, attack,
    predictor, scenes of batch 0)."""
    _, sd = _golden_weights()
    model = make_monodepth2()
    model.load_state_dict(sd)
    predictor = predictor_from(model.to(dev))
    obj, mask = make_car_object(300, 200, seed=SEED)
    attack = build_attack(CFG, predictor, obj, mask)
    batches = [make_scene(CFG.batch_size, CFG.ori_h, CFG.ori_w,
                          seed=SEED + 1 + i) for i in range(CFG.eval_count)]

    # one untimed batch first: cuDNN and allocator warm-up
    warm = dataclasses.replace(CFG, eval_count=1)
    evaluate_attacks(predictor, attack, batches[:1], warm,
                     generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = evaluate_attacks(predictor, attack, batches, CFG,
                           generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}

    log(f"slice: Monodepth2-18 {CFG.scene_w}x{CFG.scene_h} f32 eval, L-inf "
        f"PGD-{CFG.step} eps {CFG.epsilon} alpha {CFG.alpha}, batch "
        f"{CFG.batch_size} x {CFG.eval_count} batches of "
        f"{CFG.ori_w}x{CFG.ori_h} scenes, car 300x200")
    log(f"  metrics mean {json.dumps(res['mean'])}")
    log(f"  metrics max  {json.dumps(res['max'])}")
    log(f"  seconds per batch {secs / CFG.eval_count:.4f} "
        f"(host clock around {CFG.eval_count} batches, synchronised)")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    log(f"  launches {json.dumps(launches)}")
    bad = [n for n in SLICE1_KERNELS if launches[n] <= 0]
    if bad:
        raise AssertionError(f"kernels never launched on the main path: {bad}")
    vals = list(res["mean"].values()) + list(res["max"].values())
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite metrics: {res}")
    return launches, attack, predictor, torch.from_numpy(batches[0]).to(dev)


def phase_cost(attack, scenes) -> None:
    """10 steps must lower the targeted cost below the random start's,
    both under the first step's EoT draw."""
    draws = attack.draw(torch.Generator().manual_seed(SEED + 7),
                        CFG.batch_size)
    full = attack._replicate(scenes, CFG.batch_size)
    start = torch.clamp(attack.obj_img + draws.noise.to(scenes.device),
                        0.0, 1.0)
    c0, _ = attack.objective_and_grad(full, start, draws.z0s[0],
                                      draws.alphas[0])
    adv, ben, masks, obj_adv = attack(scenes, CFG.batch_size,
                                      eval_mode=True, draws=draws)
    c10, _ = attack.objective_and_grad(full, obj_adv, draws.z0s[0],
                                       draws.alphas[0])
    c0, c10 = float(c0), float(c10)
    log(f"cost: targeted cost {c0:.6e} at the random start, {c10:.6e} "
        f"after {CFG.step} steps; finals {tuple(adv.shape)} "
        f"{tuple(masks.shape)}, |obj_adv - obj| max "
        f"{float((obj_adv - attack.obj_img).abs().max()):.4f}")
    for name, t in (("adv", adv), ("ben", ben), ("masks", masks)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    if not c10 < c0:
        raise AssertionError("the attack did not lower the targeted cost")
    if float((obj_adv - attack.obj_img).abs().max()) > CFG.epsilon + 1e-6:
        raise AssertionError("the texture left the eps-ball")


def phase_breakdown(attack, predictor, scenes, rows) -> None:
    """Where one batch's time goes: median CUDA-event ms of each layer
    of one PGD step, of the finals and of the metrics."""
    draws = attack.draw(torch.Generator().manual_seed(SEED + 9),
                        CFG.batch_size)
    full = attack._replicate(scenes, CFG.batch_size)
    sm = attack._resize_scenes(full)
    obj = torch.clamp(attack.obj_img + draws.noise.to(scenes.device), 0, 1)
    z, a = draws.z0s[0], draws.alphas[0]
    with torch.no_grad():
        adv, masks = attack._model_view(full, obj, z, a, sm)
        fin = attack._final_outputs(full, obj, draws.final_z0s,
                                    draws.final_alphas, True)

    def model_fwd_bwd():
        x = adv.detach().requires_grad_(True)
        with torch.enable_grad():
            torch.autograd.grad(attack._targeted_cost(x, masks), x)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    parts = {
        "pgd_step (view + model fwd + input grad + warp adjoint)":
            lambda: attack.objective_and_grad(full, obj, z, a, sm),
        "eot_view (geometry + pass 1 + pass 2 + paste)":
            no_grad(lambda: attack._model_view(full, obj, z, a, sm)),
        "model_forward": no_grad(lambda: predictor(adv)),
        "model_forward_and_input_grad": model_fwd_bwd,
        "finals (exact warp at 1242x375 x2 + resize)":
            no_grad(lambda: attack._final_outputs(
                full, obj, draws.final_z0s, draws.final_alphas, True)),
        "metrics (2 forwards + masked errors)":
            no_grad(lambda: _batch_metrics(predictor, fin[0], fin[1],
                                           fin[2])),
    }
    log("breakdown at batch 12, 1024x320 (median CUDA-event ms, host "
        "time included):")
    for name, fn in parts.items():
        log(f"  {name}: {cuda_ms(fn, reps=10, queued=False):.3f}")
    for r in rows.values():
        log(f"  kernel {r['name']}: {r['ms']:.4f} (plain {r['plain_ms']:.4f})")


def phase_idle(attack, scenes) -> None:
    """Device idle share of one attack call (10 PGD steps + finals)."""
    draws = attack.draw(torch.Generator().manual_seed(SEED + 11),
                        CFG.batch_size)
    busy_ms, wall_ms, n, _, _ = device_busy(
        lambda: attack(scenes, CFG.batch_size, eval_mode=True, draws=draws))
    log(f"idle: one attack call (PGD-{CFG.step} + finals) under the "
        f"profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms host "
        f"wall, idle share {1.0 - busy_ms / wall_ms:.4f}, "
        f"{n} device activities")


def device_busy(fn):
    """(busy ms, host wall ms, device activities, ms by activity name,
    launches by activity name) of one call of fn: the union of the card's
    kernel and copy intervals in a torch.profiler trace, against the host
    clock around the call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(("Buffer Flush", "Activity Buffer"))]
    if not events:
        raise AssertionError("the profiler saw no device activity")
    by_name, counts = {}, {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
        counts[e.name] = counts.get(e.name, 0) + 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e3, wall_ms, len(spans), by_name, counts


def reflect_pads(by_name, counts):
    """(forward ms, launches, backward ms, launches) of the reflection-pad
    kernels (F.pad's reflect mode and its backward) in a profile."""
    out = [0.0, 0, 0.0, 0]
    for k, ms in by_name.items():
        if "reflection_pad2d" in k:
            i = 2 if "backward" in k else 0
            out[i] += ms
            out[i + 1] += counts[k]
    return tuple(out)


# -- phase 8 -----------------------------------------------------------------
TRAIN_CFG = HardeningConfig(
    selfsup=SelfSupConfig(height=320, width=1024, frame_ids=("0", "s")),
    supervised_adv=False, contrastive_learning=False, batch_size=32,
    learning_rate=1e-5)
TRAIN_WARMUP, TRAIN_TIMED, CONVERGE_STEPS, CONVERGE_LR = 2, 5, 6, 1e-4


def _train_inputs(dev):
    """Synthetic 375x1242 frames: "s" is "0" shifted by 12 columns, so
    the stereo warp has real signal; sides and flips mixed over the
    batch."""
    B = TRAIN_CFG.batch_size
    f0 = torch.from_numpy(make_scene(B, TRAIN_CFG.adv.ori_h,
                                     TRAIN_CFG.adv.ori_w, seed=SEED + 20))
    frames = {"0": f0.to(dev), "s": torch.roll(f0, 12, dims=2).to(dev)}
    side = torch.arange(B, device=dev) % 2 == 0
    flip = torch.arange(B, device=dev) % 4 < 2
    return frames, side, flip


def _moved(before, after):
    return [k for k in before if not torch.equal(before[k], after[k])]


def phase_train(dev):
    """The self-supervised stereo step at full width; returns the launch
    counts of the timed steps."""
    phase_train_parity(dev)
    ss = TRAIN_CFG.selfsup
    B = TRAIN_CFG.batch_size
    frames, side, flip = _train_inputs(dev)
    trainer = HardeningTrainer(TRAIN_CFG, torch.Generator().manual_seed(SEED),
                               *make_car_object(300, 200, seed=SEED),
                               device=dev)
    state = trainer.make_state()
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, m = trainer.selfsup_frames_step(state, frames, side, flip)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        state, m = trainer.selfsup_frames_step(state, frames, side, flip)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / TRAIN_TIMED
    launches = {k.name: k.launches for k in _build.KERNELS}
    losses = [float(v) for v in losses]

    log(f"train: HardeningTrainer.selfsup_frames_step, Monodepth2-"
        f"{TRAIN_CFG.num_layers} from scratch, {ss.width}x{ss.height} f32, "
        f"scales {ss.scales}, frames {ss.frame_ids}, batch {B} of "
        f"{TRAIN_CFG.adv.ori_w}x{TRAIN_CFG.adv.ori_h} frames, Adam lr "
        f"{TRAIN_CFG.learning_rate}")
    log(f"  seconds per step {secs:.4f} (host clock around {TRAIN_TIMED} "
        f"steps after {TRAIN_WARMUP} warm-up, synchronised)")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    log(f"  losses {json.dumps(losses)}")
    log(f"  launches {json.dumps(launches)} (per step: reproj fwd "
        f"{launches['reproj_loss_fwd'] / TRAIN_TIMED:g}, bwd "
        f"{launches['reproj_loss_bwd_q'] / TRAIN_TIMED:g}; conv fwd "
        f"{launches['conv3x3_fwd'] / TRAIN_TIMED:g}, dgrad "
        f"{launches['conv3x3_dgrad'] / TRAIN_TIMED:g})")
    bad = [n for n in TRAIN_KERNELS if launches[n] <= 0]
    if bad:
        raise AssertionError(f"kernels never launched in training: {bad}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if state.step != TRAIN_WARMUP + TRAIN_TIMED:
        raise AssertionError(f"step count {state.step}")
    moved = _moved(start, state.model.state_dict())
    params = [n for n, _ in state.model.named_parameters()]
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]
    if set(params) - set(moved) or set(stats) - set(moved):
        raise AssertionError("some weights or BatchNorm statistics did not "
                             "move: " + str(sorted((set(params) | set(stats))
                                                   - set(moved))[:5]))
    log(f"  moved: all {len(params)} parameters and {len(stats)} running "
        f"statistics; step {state.step}")
    phase_train_breakdown(trainer, state, frames, side, flip)
    del state
    phase_converge(dev, frames, side, flip)
    return launches


def phase_train_breakdown(trainer, state, frames, side, flip) -> None:
    """Median CUDA-event ms of the parts of one step, and the idle share
    of one whole step."""
    ss = TRAIN_CFG.selfsup
    names = ("batch", "model_forward", "losses_forward", "backward",
             "optimizer_step")
    times = {n: [] for n in names}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        batch = trainer.plain_batch(frames, side, flip)
        noise = trainer.draw_identity_noise(TRAIN_CFG.batch_size)
        ev[1].record()
        disps = trainer.disparities(state.model, batch)
        ev[2].record()
        loss, _ = compute_selfsup_losses(disps, batch, {}, noise, ss)
        ev[3].record()
        loss.backward()
        ev[4].record()
        trainer._apply_grads(state)
        ev[5].record()
        ev[5].synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
    log(f"train breakdown at batch {TRAIN_CFG.batch_size}, "
        f"{ss.width}x{ss.height} (median CUDA-event ms of 5):")
    for n in names:
        log(f"  {n}: {float(np.median(times[n])):.3f}")
    busy_ms, wall_ms, n, by_name, _ = device_busy(
        lambda: trainer.selfsup_frames_step(state, frames, side, flip))
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    log("  device ms of the step by kernel (top 10):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms:9.3f}  {name[:110]}")


# card-vs-CPU parity of a step's weight gradients: relative L2 error per
# tensor and over all of them (the CPU tests' tolerances against JAX, in
# tests/test_torch_distill.py); a wrong or sign-flipped gradient is off
# by about 1 or more, which the 2.5 lr rule on parameters cannot see
GRAD_L2, GRAD_L2_ALL = 2e-2, 1e-2


def grad_l2(model, ref_model):
    """(worst per-tensor, overall) relative L2 error of `model`'s .grad
    to `ref_model`'s, over the parameters that have one; the two must
    agree on which do."""
    worst, num, den = 0.0, 0.0, 0.0
    for p, q in zip(model.parameters(), ref_model.parameters()):
        if (p.grad is None) != (q.grad is None):
            raise AssertionError("the card and the CPU differ in which "
                                 "parameters got a gradient")
        if q.grad is None:
            continue
        want = q.grad.double()
        err = float((p.grad.detach().cpu().double() - want).norm())
        ref = float(want.norm())
        worst = max(worst, err / ref)
        num, den = num + err ** 2, den + ref ** 2
    return worst, (num / den) ** 0.5


def phase_train_parity(dev) -> None:
    """One step at 64x128, batch 2, on the card (the kernels) and on the
    CPU (the plain versions), from the same weights, frames and noise:
    loss within 1e-5 relative (kernel D sums in another order than the
    CPU's conv, so the bits may differ); weight gradients within GRAD_L2
    per tensor and GRAD_L2_ALL overall; parameters within 2.5 lr after
    Adam: its first step moves each by less than lr, so a sign split
    comes within a hair of 2 lr, and a parameter near 1 (the BatchNorm
    scales) rounds by up to 1.2e-3 lr more."""
    ss = dataclasses.replace(TRAIN_CFG.selfsup, height=64, width=128)
    adv = dataclasses.replace(TRAIN_CFG.adv, ori_h=96, ori_w=320)
    cfg = dataclasses.replace(TRAIN_CFG, selfsup=ss, adv=adv, batch_size=2,
                              learning_rate=CONVERGE_LR)
    f0 = torch.from_numpy(make_scene(2, 96, 320, seed=SEED + 30))
    frames = {"0": f0, "s": torch.roll(f0, 6, dims=2)}
    side, flip = torch.tensor([True, False]), torch.tensor([False, True])
    noise = torch.randn((2, 64, 128, 1),
                        generator=torch.Generator().manual_seed(SEED + 31))
    def step_on(d):
        trainer = HardeningTrainer(
            cfg, torch.Generator().manual_seed(SEED + 32),
            *make_car_object(36, 24, seed=SEED), device=d)
        state, m = trainer.selfsup_frames_step(
            trainer.make_state(), {k: v.to(d) for k, v in frames.items()},
            side.to(d), flip.to(d), identity_noise=noise.to(d))
        return float(m["loss"]), state.model

    (l_cpu, m_cpu), (l_gpu, m_gpu) = step_on(torch.device("cpu")), step_on(dev)
    worst = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(m_gpu.parameters(), m_cpu.parameters()))
    g_worst, g_all = grad_l2(m_gpu, m_cpu)
    log(f"train parity: one step at 64x128 batch 2, card {l_gpu:.8f} vs "
        f"CPU {l_cpu:.8f} loss (rel {abs(l_gpu - l_cpu) / l_cpu:.3e}), "
        f"gradient rel L2 {g_worst:.3e} worst tensor, {g_all:.3e} overall, "
        f"max |param difference| {worst / CONVERGE_LR:.3f} lr")
    if (abs(l_gpu - l_cpu) > 1e-5 * l_cpu or worst > 2.5 * CONVERGE_LR
            or g_worst > GRAD_L2 or g_all > GRAD_L2_ALL):
        raise AssertionError("the card's training step disagrees with the "
                             "plain versions on the CPU")


def phase_converge(dev, frames, side, flip) -> None:
    """Steps on one fixed batch at Monodepth2's own lr 1e-4 lower the
    loss below step 0's."""
    cfg = dataclasses.replace(TRAIN_CFG, learning_rate=CONVERGE_LR)
    trainer = HardeningTrainer(cfg, torch.Generator().manual_seed(SEED + 1),
                               *make_car_object(300, 200, seed=SEED),
                               device=dev)
    state = trainer.make_state()
    losses = []
    for _ in range(CONVERGE_STEPS + 1):
        state, m = trainer.selfsup_frames_step(state, frames, side, flip)
        losses.append(float(m["loss"]))
    log(f"converge: lr {CONVERGE_LR}, one fixed batch, losses "
        f"{json.dumps(losses)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{CONVERGE_STEPS} steps did not lower the "
                             "loss")


# -- phase 9 -----------------------------------------------------------------
DISTILL_CFG = DistillConfig(batch_size=32)
DISTILL_WARMUP, DISTILL_TIMED, DISTILL_FIT_STEPS = 2, 5, 6
# kernel D per step: the 4 convs of the scale-0 path forward in the 10
# attack passes, the teacher's and the student's; their input gradients
# in the attack's passes and the student's; weight gradients only in the
# student's backward (the attack runs on detached weights)
D_FWD_PER_STEP = 4 * (DISTILL_CFG.steps + 2)
D_DGRAD_PER_STEP = 4 * (DISTILL_CFG.steps + 1)
D_WGRAD_PER_STEP = 4
# reflection-pad launches per step (F.pad's reflect kernel, its backward):
# every decoder conv of the scale-0 path reflect-pads its input in each
# forward pass, and the pad's backward runs in each input gradient pass;
# 7 of its 11 convs have more than 64 channels in or out and take
# F.conv2d (upconv_4_0 .. upconv_2_1 and upconv_1_1), the other 4 kernel
# D. float32 D convs pad as well; bf16 D folds the pad in and pads only
# for the student's weight gradients
WIDE_CONVS = 7
DISTILL_PADS = ((WIDE_CONVS + 4) * (DISTILL_CFG.steps + 2),
                (WIDE_CONVS + 4) * (DISTILL_CFG.steps + 1))
DISTILL_CROP = dict(attack_crop_w=320, attack_crop_h=256)  # bench.py's
# the disparity heads at scales 1..3, which the step never evaluates
UNUSED_HEADS = tuple(f"decoder.decoder.{i}.conv.{p}" for i in (11, 12, 13)
                     for p in ("weight", "bias"))
# small-step parity: texels whose PGD sign may split between the card
# and the CPU (a gradient near 0 at a kink of the model, where rounding
# decides; the JAX package's jitted and eager attacks split 2.6% of the
# texture on the CPU test's fixture)
DISTILL_SPLIT_MAX = 0.05


@contextlib.contextmanager
def counting_weight_grads():
    """Counts kernel D's weight-gradient convs while active."""
    calls = []
    orig = conv.weight_grad
    conv.weight_grad = lambda *a: calls.append(1) or orig(*a)
    try:
        yield calls
    finally:
        conv.weight_grad = orig


@contextlib.contextmanager
def recording_shapes(kernel, args: slice):
    """Records tuple(launch arguments[args]) of each launch of `kernel`
    while active (kernel D's forward: slice(4, 9), (B, Cin, H + 2, W + 2,
    Co); the pool's forward slice(2, 6), its backward slice(3, 7), (B, C,
    H, W)); the launches still count."""
    shapes = []
    orig = kernel.launch

    def launch(*a):
        orig(*a)
        shapes.append(tuple(a[args]))

    kernel.launch = launch
    try:
        yield shapes
    finally:
        del kernel.launch


def _distill_trainer(dev, cfg, sd, obj, mask, seed):
    teacher = make_monodepth2()
    teacher.load_state_dict(sd)
    return DistillTrainer(cfg, torch.Generator().manual_seed(seed), obj,
                          mask, predictor_from(teacher.to(dev)), device=dev,
                          init_state_dict=sd)


def phase_distill(dev):
    """The distillation step at config 3; returns the launch counts of
    the timed steps."""
    phase_distill_parity(dev)
    cfg = DISTILL_CFG
    B = cfg.batch_size
    _, sd = _golden_weights()
    obj, mask = make_car_object(300, 200, seed=SEED)
    scenes = torch.from_numpy(make_scene(B, cfg.ori_h, cfg.ori_w,
                                         seed=SEED + 40)).to(dev)
    trainer = _distill_trainer(dev, cfg, sd, obj, mask, SEED)
    state = trainer.make_state()
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses = []
    for _ in range(DISTILL_WARMUP):
        state, m = trainer.train_step(state, scenes)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    with counting_weight_grads() as wgrads:
        t0 = time.perf_counter()
        for _ in range(DISTILL_TIMED):
            state, m = trainer.train_step(state, scenes)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / DISTILL_TIMED
    launches = {k.name: k.launches for k in _build.KERNELS}
    losses = [float(v) for v in losses]

    log(f"distill: DistillTrainer.train_step, Monodepth2-18 teacher and "
        f"student from the golden weights, {cfg.scene_w}x{cfg.scene_h} f32, "
        f"L-inf PGD-{cfg.steps} object attack eps {cfg.epsilon} alpha "
        f"{cfg.alpha}, full-frame objective, batch {B} of "
        f"{cfg.ori_w}x{cfg.ori_h} scenes, car 300x200, Adam lr "
        f"{cfg.learning_rate}")
    log(f"  seconds per step {secs:.4f} (host clock around {DISTILL_TIMED} "
        f"steps after {DISTILL_WARMUP} warm-up, synchronised)")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    log(f"  losses {json.dumps(losses)}")
    per_step = {n: launches[n] / DISTILL_TIMED for n in CONV_KERNELS}
    log(f"  launches {json.dumps(launches)} (per step: conv fwd "
        f"{per_step['conv3x3_fwd']:g}, dgrad {per_step['conv3x3_dgrad']:g}, "
        f"weight gradients {len(wgrads) / DISTILL_TIMED:g}; predicted "
        f"{D_FWD_PER_STEP}, {D_DGRAD_PER_STEP}, {D_WGRAD_PER_STEP})")
    bad = [n for n in DISTILL_KERNELS if launches[n] <= 0]
    if bad:
        raise AssertionError(f"kernels never launched in distillation: {bad}")
    if (per_step["conv3x3_fwd"] != D_FWD_PER_STEP
            or per_step["conv3x3_dgrad"] != D_DGRAD_PER_STEP
            or len(wgrads) != D_WGRAD_PER_STEP * DISTILL_TIMED):
        raise AssertionError("kernel D did not launch as predicted")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite distillation loss: {losses}")
    end = state.model.state_dict()
    moved = set(_moved(start, end))
    params = [n for n, _ in state.model.named_parameters()]
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]
    still = (set(params) | set(stats)) - moved - set(UNUSED_HEADS)
    if still or moved & set(UNUSED_HEADS):
        raise AssertionError(f"not moved: {sorted(still)[:5]}; unused heads "
                             f"moved: {sorted(moved & set(UNUSED_HEADS))}")
    log(f"  moved: {len(params) - len(UNUSED_HEADS)} parameters and "
        f"{len(stats)} running statistics; the {len(UNUSED_HEADS)} "
        f"parameters of the unused heads bit-unchanged; step {state.step}")
    phase_distill_breakdown(trainer, state, scenes)
    del state
    torch.cuda.empty_cache()
    phase_distill_fit(trainer, scenes)
    phase_distill_crop(dev, sd, obj, mask, scenes)
    return launches


def phase_distill_parity(dev) -> None:
    """One small step (375x1242 scenes, the model at 96x320, a 40x60
    car, batch 2, PGD-2) on the card and on the CPU's plain versions,
    from the same weights and draws: the attacked textures split on at
    most DISTILL_SPLIT_MAX of the texels; then the training half on the
    CPU's composites: loss within 1e-5 relative, weight gradients and
    parameters as phase 8's parity."""
    _, sd = _golden_weights()
    cfg = dataclasses.replace(DISTILL_CFG, batch_size=2, steps=2,
                              scene_h=96, scene_w=320)
    obj, mask = make_car_object(60, 40, seed=SEED)
    scenes = torch.from_numpy(make_scene(2, cfg.ori_h, cfg.ori_w,
                                         seed=SEED + 43))
    runs = []  # the CPU's, then the card's
    for d in (torch.device("cpu"), dev):
        trainer = _distill_trainer(d, cfg, sd, obj, mask, SEED + 44)
        draws = trainer.attack.draw(torch.Generator().manual_seed(SEED + 45),
                                    2)
        state = trainer.make_state()
        runs.append((trainer, state, trainer.attack_student(state)(
            scenes.to(d), 2, eval_mode=False, draws=draws)))
    adv, ben, _, obj_cpu = runs[0][2]
    split = float(((runs[1][2][3].cpu() - obj_cpu).abs() > 1e-6)
                  .float().mean())
    out = []
    for trainer, state, _ in runs:
        state, m = trainer.distill_step(state, adv.to(trainer.device),
                                        ben.to(trainer.device))
        out.append((float(m["loss"]), state.model))
    (l_cpu, m_cpu), (l_gpu, m_gpu) = out
    worst = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(m_gpu.parameters(), m_cpu.parameters()))
    g_worst, g_all = grad_l2(m_gpu, m_cpu)
    lr = cfg.learning_rate
    log(f"distill parity: one step at 96x320 batch 2 PGD-2: texture "
        f"sign splits {split:.4%} (max {DISTILL_SPLIT_MAX:.0%}); on the "
        f"CPU's composites card {l_gpu:.8e} vs CPU {l_cpu:.8e} loss (rel "
        f"{abs(l_gpu - l_cpu) / l_cpu:.3e}), gradient rel L2 "
        f"{g_worst:.3e} worst tensor, {g_all:.3e} overall, max |param "
        f"difference| {worst / lr:.3f} lr")
    if (split > DISTILL_SPLIT_MAX or abs(l_gpu - l_cpu) > 1e-5 * l_cpu
            or worst > 2.5 * lr or g_worst > GRAD_L2
            or g_all > GRAD_L2_ALL):
        raise AssertionError("the card's distillation step disagrees with "
                             "the plain versions on the CPU")


def phase_distill_breakdown(trainer, state, scenes) -> None:
    """Median CUDA-event ms of the parts of one step (3 steps), then one
    whole step under the profiler: idle share, device ms by kernel and
    kernel D's share."""
    B = DISTILL_CFG.batch_size
    names = ("attack (PGD-10: views, forwards, input gradients)",
             "finals (tiled pair warp)", "teacher_forward",
             "student_forward_and_loss", "backward", "adam")
    times = {n: [] for n in names}
    gen = torch.Generator().manual_seed(SEED + 42)
    for _ in range(3):
        draws = trainer.attack.draw(gen, B)
        atk = trainer.attack_student(state)
        full = atk._replicate(scenes, B)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        obj_adv = atk._optimize(full, draws)
        ev[1].record()
        adv, ben, _ = atk._final_outputs(full, obj_adv, draws.final_z0s,
                                         draws.final_alphas, False)
        ev[2].record()
        disp_gt = trainer.teacher_disp(ben)
        ev[3].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((disp_gt - trainer.student_disp(state, adv)) ** 2)
        ev[4].record()
        loss.backward()
        ev[5].record()
        state.optimizer.step()
        ev[6].record()
        ev[6].synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
    log(f"distill breakdown at batch {B}, {DISTILL_CFG.scene_w}x"
        f"{DISTILL_CFG.scene_h} (median CUDA-event ms of 3):")
    for n in names:
        log(f"  {n}: {float(np.median(times[n])):.3f}")
    busy_ms, wall_ms, n, by_name, counts = device_busy(
        lambda: trainer.train_step(state, scenes))
    d_ms = sum(ms for k, ms in by_name.items() if "conv3x3_" in k)
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    log(f"  kernel D: {d_ms:.3f} device ms of the step, "
        f"{d_ms / busy_ms:.4f} of its busy time")
    check_reflect_pads("distill", by_name, counts, DISTILL_PADS)
    log("  device ms of the step by kernel (top 12):")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:9.3f}  {k[:110]}")


def check_reflect_pads(label, by_name, counts, predicted) -> None:
    """Logs a profiled step's reflection-pad kernels (ms and launches);
    their launches must be `predicted` (forward, backward)."""
    f_ms, f_n, b_ms, b_n = reflect_pads(by_name, counts)
    log(f"  reflection pad: forward {f_ms:.3f} device ms in {f_n} "
        f"launches, backward {b_ms:.3f} ms in {b_n} (predicted "
        f"{predicted[0]} + {predicted[1]})")
    if (f_n, b_n) != predicted:
        raise AssertionError(f"{label}: reflection pads launched {f_n} + "
                             f"{b_n} times, predicted {predicted}")


def phase_distill_fit(trainer, scenes) -> None:
    """Adam steps on one fixed adversarial batch lower the student's MSE
    against the teacher."""
    B = DISTILL_CFG.batch_size
    state = trainer.make_state()
    adv, ben, _, _ = trainer.attack_student(state)(
        scenes, B, torch.Generator().manual_seed(SEED + 41))
    losses = []
    for _ in range(DISTILL_FIT_STEPS + 1):
        state, m = trainer.distill_step(state, adv, ben)
        losses.append(float(m["loss"]))
    log(f"distill fit: {DISTILL_FIT_STEPS} Adam steps on one adversarial "
        f"batch, MSE {json.dumps(losses)}")
    if not losses[-1] < losses[0]:
        raise AssertionError("Adam steps did not lower the distillation MSE")


def phase_distill_crop(dev, sd, obj, mask, scenes) -> None:
    """One untimed step with the cropped objective launches kernel D at
    the crop's shape (upconv_0_1 on a 256x320 window)."""
    cfg = dataclasses.replace(DISTILL_CFG, **DISTILL_CROP)
    trainer = _distill_trainer(dev, cfg, sd, obj, mask, SEED + 46)
    state = trainer.make_state()
    with recording_shapes(conv.FWD, slice(4, 9)) as shapes:
        state, m = trainer.train_step(state, scenes)
        torch.cuda.synchronize()
    want = (cfg.batch_size, 16, cfg.attack_crop_h + 2, cfg.attack_crop_w + 2,
            16)
    log(f"distill crop: attack_crop {cfg.attack_crop_w}x{cfg.attack_crop_h}, "
        f"loss {float(m['loss']):.6e}, {shapes.count(want)} of "
        f"{len(shapes)} D forward launches at {want}")
    if not math.isfinite(float(m["loss"])) or shapes.count(want) != \
            cfg.steps:
        raise AssertionError("the cropped objective did not run kernel D "
                             "at the crop's shape once per PGD step")


# -- phase 10 ----------------------------------------------------------------
# bench.py's distillation settings (:81-115) in the port
BENCH_CFG = DistillConfig(
    adv_type="object", epsilon=0.1, alpha=0.005, steps=10, batch_size=32,
    compute_dtype="bfloat16", attack_crop_w=320, attack_crop_h=256,
    attack_view_dtype="bfloat16", attack_scale=0, fold_bn=True)
BENCH_KERNELS = ("vertical_resample_fwd", "vertical_resample_bwd",
                 "maxpool3x3s2_fwd_bf16", "maxpool3x3s2_bwd_bf16"
                 ) + CONV_BF16_KERNELS
BENCH_WARMUP, BENCH_TIMED = 2, 5
# per step, all in bf16: D as phase 9 (the crop changes its shapes, not
# its count); the stem pool once per forward and per input gradient
BENCH_PER_STEP = {"conv3x3_fwd_bf16": D_FWD_PER_STEP,
                  "conv3x3_dgrad_bf16": D_DGRAD_PER_STEP,
                  "maxpool3x3s2_fwd_bf16": BENCH_CFG.steps + 2,
                  "maxpool3x3s2_bwd_bf16": BENCH_CFG.steps + 1,
                  "conv3x3_fwd": 0, "conv3x3_dgrad": 0,
                  "maxpool3x3s2_fwd": 0, "maxpool3x3s2_bwd": 0}
# B-bf16's launches a step by input shape: the attack's PGD passes on the
# crop's stem, forward and input gradient; at full frame the teacher's
# and the student's forward and the student's backward
BENCH_POOL_SHAPES = {
    "maxpool3x3s2_fwd_bf16": {POOL_CROP_SHAPE: BENCH_CFG.steps,
                              POOL_FULL_SHAPE: 2},
    "maxpool3x3s2_bwd_bf16": {POOL_CROP_SHAPE: BENCH_CFG.steps,
                              POOL_FULL_SHAPE: 1}}
# the coarse objective at scale 1 with one fine step: each of the other
# steps - 1 attack passes runs upconv_1_0 and dispconv_1 instead of the
# scale-0 path's 4 convs of D (upconv_0_0, upconv_0_1 and dispconv_0
# are not evaluated)
BENCH_PADS = (WIDE_CONVS * (BENCH_CFG.steps + 2) + D_WGRAD_PER_STEP,
              WIDE_CONVS * (BENCH_CFG.steps + 1))
BENCH_SCALE = dict(attack_scale=1, attack_scale_fine_steps=1)
_COARSE = BENCH_CFG.steps - BENCH_SCALE["attack_scale_fine_steps"]
BENCH_SCALE_PER_STEP = {"conv3x3_fwd_bf16": D_FWD_PER_STEP - 2 * _COARSE,
                        "conv3x3_dgrad_bf16": D_DGRAD_PER_STEP - 2 * _COARSE}
# the small step on the card against the CPU's plain versions, both bf16:
# the two round differently (kernel D and cuBLAS against oneDNN), so
# sign-PGD texels split and gradients differ by bf16 noise (0.1 relative
# L2 overall between the JAX package's and the port's bf16 steps on the
# CPU, tests/test_torch_bf16.py); a wrong kernel is off by about 1. On an
# H100 80GB HBM3 at 700 W: 2.4% split, loss 1.3e-4, gradients 3.2e-2
BENCH_SPLIT_MAX, BENCH_LOSS_RTOL, BENCH_GRAD_L2_ALL = 0.1, 1e-3, 0.1


def calibrated_teacher(dev, sd):
    """The golden weights with every BatchNorm's running statistics set
    to its batch statistics on 4 synthetic scenes at 1024x320, as a
    trained model's match its data (the golden statistics are random and
    drive deep features to O(100), where bf16 keeps no digit after the
    point)."""
    model = make_monodepth2()
    model.load_state_dict(sd)
    model = model.to(dev).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # a cumulative average: this one batch
    scenes = torch.from_numpy(make_scene(4, 375, 1242, seed=SEED + 50))
    with torch.no_grad():
        model.features_and_disps(bilinear_resize(scenes.to(dev), 320, 1024))
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


def _bench_trainer(dev, cfg, teacher_sd, obj, mask, seed):
    """bench.py's pair: a bf16, folded, disp0 teacher; a student from a
    seeded from-scratch init."""
    teacher = make_monodepth2(dtype=cfg.compute_dtype, fold_bn=True)
    teacher.load_state_dict(teacher_sd)
    return DistillTrainer(
        cfg, torch.Generator().manual_seed(seed), obj, mask,
        predictor_from(teacher.to(dev), scales=(0,)), device=dev)


def phase_bench(dev):
    """The bench configuration's distillation step; returns the launch
    counts of the timed steps."""
    _, sd = _golden_weights()
    teacher_sd = calibrated_teacher(dev, sd)
    phase_bench_parity(dev, teacher_sd)
    cfg = BENCH_CFG
    B = cfg.batch_size
    obj, mask = make_car_object(300, 200, seed=SEED)
    # bench.py steps one scene, replicated to the batch
    scenes = torch.from_numpy(make_scene(1, cfg.ori_h, cfg.ori_w,
                                         seed=SEED + 60)).to(dev)
    trainer = _bench_trainer(dev, cfg, teacher_sd, obj, mask, SEED + 61)
    state = trainer.make_state()
    losses = []
    for _ in range(BENCH_WARMUP):
        state, m = trainer.train_step(state, scenes)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    with recording_shapes(pool.FWD_BF16, slice(2, 6)) as pool_fwd, \
            recording_shapes(pool.BWD_BF16, slice(3, 7)) as pool_bwd:
        t0 = time.perf_counter()
        for _ in range(BENCH_TIMED):
            state, m = trainer.train_step(state, scenes)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / BENCH_TIMED
    launches = {k.name: k.launches for k in _build.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(v) for v in losses]
    per_step = {n: launches[n] / BENCH_TIMED for n in BENCH_PER_STEP}
    log(f"bench: DistillTrainer.train_step in bench.py's configuration: "
        f"Monodepth2-18 {cfg.scene_w}x{cfg.scene_h} compute bf16, teacher "
        f"bf16 folded disp0 (golden weights, statistics calibrated), "
        f"student from a seeded init, L-inf PGD-{cfg.steps} eps "
        f"{cfg.epsilon} alpha {cfg.alpha} on the {cfg.attack_crop_w}x"
        f"{cfg.attack_crop_h} crop, bf16 view, fold_bn, batch {B} of one "
        f"{cfg.ori_w}x{cfg.ori_h} scene, car 300x200, Adam lr "
        f"{cfg.learning_rate}")
    log(f"  seconds per step {secs:.4f} (host clock around {BENCH_TIMED} "
        f"steps after {BENCH_WARMUP} warm-up, synchronised)")
    log(f"  max_memory_allocated {peak} B")
    log(f"  losses {json.dumps(losses)}")
    log(f"  launches {json.dumps(launches)}")
    log(f"  per step {json.dumps(per_step)} (predicted "
        f"{json.dumps(BENCH_PER_STEP)})")
    bad = [n for n in BENCH_KERNELS if launches[n] <= 0]
    if bad:
        raise AssertionError(f"kernels never launched in phase 10: {bad}")
    if per_step != {n: float(v) for n, v in BENCH_PER_STEP.items()}:
        raise AssertionError("kernels D and B did not launch as predicted")
    by_shape = {n: {str(sh): shapes.count(sh) / BENCH_TIMED
                    for sh in sorted(set(shapes))}
                for n, shapes in (("maxpool3x3s2_fwd_bf16", pool_fwd),
                                  ("maxpool3x3s2_bwd_bf16", pool_bwd))}
    want = {n: {str(sh): float(k) for sh, k in v.items()}
            for n, v in BENCH_POOL_SHAPES.items()}
    log(f"  B-bf16 launches a step by input shape {json.dumps(by_shape)} "
        f"(predicted {json.dumps(want)})")
    if by_shape != want:
        raise AssertionError("B-bf16 did not launch at the predicted shapes")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite distillation loss: {losses}")
    busy_ms, wall_ms, n, by_name, counts = device_busy(
        lambda: trainer.train_step(state, scenes))
    d_ms = sum(ms for k, ms in by_name.items() if "conv3x3_" in k)
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    log(f"  kernel D: {d_ms:.3f} device ms of the step, "
        f"{d_ms / busy_ms:.4f} of its busy time")
    for k in ("pool_fwd_bf16", "pool_bwd_bf16"):
        k_ms = sum(ms for n, ms in by_name.items() if k in n)
        k_n = sum(c for n, c in counts.items() if k in n)
        log(f"  {k}: {k_ms:.3f} device ms of the step in {k_n} launches")
    check_reflect_pads("bench", by_name, counts, BENCH_PADS)
    log("  device ms of the step by kernel (top 20):")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        log(f"    {ms:9.3f}  {k[:110]}")
    del state, trainer
    torch.cuda.empty_cache()
    phase_bench_scale(dev, teacher_sd, obj, mask, scenes)
    return launches


def phase_bench_parity(dev, teacher_sd) -> None:
    """One small bench-configuration step (375x1242 scenes, the model at
    96x320, a 40x60 car, batch 2, PGD-2, a 128x64 crop) on the card and
    on the CPU's plain versions, from the same weights and draws: the
    textures split on at most BENCH_SPLIT_MAX of the texels; the training
    half on the CPU's composites within BENCH_LOSS_RTOL in loss and
    BENCH_GRAD_L2_ALL in the gradients' overall relative L2."""
    cfg = dataclasses.replace(
        BENCH_CFG, batch_size=2, steps=2, scene_h=96, scene_w=320,
        attack_crop_w=128, attack_crop_h=64, tile_h=64, tile_w=128)
    obj, mask = make_car_object(60, 40, seed=SEED)
    scenes = torch.from_numpy(make_scene(2, cfg.ori_h, cfg.ori_w,
                                         seed=SEED + 62))
    runs = []  # the CPU's, then the card's
    for d in (torch.device("cpu"), dev):
        trainer = _bench_trainer(d, cfg, teacher_sd, obj, mask, SEED + 63)
        draws = trainer.attack.draw(torch.Generator().manual_seed(SEED + 64),
                                    2)
        state = trainer.make_state()
        runs.append((trainer, state, trainer.attack_student(state)(
            scenes.to(d), 2, eval_mode=False, draws=draws)))
    adv, ben, _, obj_cpu = runs[0][2]
    split = float(((runs[1][2][3].cpu() - obj_cpu).abs() > 1e-6)
                  .float().mean())
    out = []
    for trainer, state, _ in runs:
        state, m = trainer.distill_step(state, adv.to(trainer.device),
                                        ben.to(trainer.device))
        out.append((float(m["loss"]), state.model))
    (l_cpu, m_cpu), (l_gpu, m_gpu) = out
    g_worst, g_all = grad_l2(m_gpu, m_cpu)
    log(f"bench parity: one bf16 step at 96x320 batch 2 PGD-2 on a 128x64 "
        f"crop: texture sign splits {split:.4%} (max "
        f"{BENCH_SPLIT_MAX:.0%}); on the CPU's composites card "
        f"{l_gpu:.8e} vs CPU {l_cpu:.8e} loss (rel "
        f"{abs(l_gpu - l_cpu) / l_cpu:.3e}, max {BENCH_LOSS_RTOL}), "
        f"gradient rel L2 {g_worst:.3e} worst tensor, {g_all:.3e} overall "
        f"(max {BENCH_GRAD_L2_ALL})")
    if (split > BENCH_SPLIT_MAX or abs(l_gpu - l_cpu) > BENCH_LOSS_RTOL * l_cpu
            or g_all > BENCH_GRAD_L2_ALL or not math.isfinite(l_gpu)):
        raise AssertionError("the card's bf16 distillation step disagrees "
                             "with the plain versions on the CPU")


def phase_bench_scale(dev, teacher_sd, obj, mask, scenes) -> None:
    """One untimed step with the coarse-scale objective (attack_scale 1,
    one fine step): kernel D launches fall by the skipped convs, the loss
    is finite."""
    cfg = dataclasses.replace(BENCH_CFG, **BENCH_SCALE)
    trainer = _bench_trainer(dev, cfg, teacher_sd, obj, mask, SEED + 65)
    state = trainer.make_state()
    _build.reset_launches()
    state, m = trainer.train_step(state, scenes)
    torch.cuda.synchronize()
    kernels = {k.name: k for k in _build.KERNELS}
    got = {n: kernels[n].launches for n in BENCH_SCALE_PER_STEP}
    log(f"bench coarse objective: attack_scale 1, 1 fine step: loss "
        f"{float(m['loss']):.6e}, D launches {json.dumps(got)} (predicted "
        f"{json.dumps(BENCH_SCALE_PER_STEP)}; {json.dumps(BENCH_PER_STEP)} "
        f"at scale 0)")
    if got != BENCH_SCALE_PER_STEP or not math.isfinite(float(m["loss"])):
        raise AssertionError("the coarse objective did not skip the scale-0 "
                             "convs of its coarse passes")


# -- phase 11 ----------------------------------------------------------------
# the CLI's `train-hardening --fine-tune --norm-type l_0` (cli/main.py:594-
# 627): frames ("0", "s"), L0 with 10 steps on attack batch 12, batch 32,
# lr 1e-5, supervised + contrastive + photometric, fold_bn
HARDEN_CFG = HardeningConfig(
    selfsup=SelfSupConfig(height=320, width=1024, frame_ids=("0", "s")),
    adv=AdvSynthConfig(norm_type="l_0", steps=10, attack_batch_size=12),
    batch_size=32, learning_rate=1e-5)
HARDEN_WARMUP, HARDEN_TIMED = 2, 5
# each kernel instance's functions as the profiler names them
KERNEL_NAMES = {
    "A (warp)": ("::vert_fwd", "::vert_bwd"),
    "B (pool, float32)": ("::pool_fwd<", "::pool_bwd<"),
    "B-bf16 (pool)": ("pool_fwd_bf16", "pool_bwd_bf16"),
    "C (reprojection)": ("::fwd_kernel(", "::bwd_q_kernel(",
                         "::bwd_grad_kernel("),
    "D (conv, float32)": ("::conv3x3_mma", "::conv3x3_co1"),
    "D-bf16 (conv)": ("conv3x3_bf16_",)}
# small-step parity on the card against the CPU: gradients within 1e-2
# relative L2 over all tensors (phase 9's rule) and 0.1 per tensor, a
# tensor below 1e-3 of the largest tensor's norm held relative to that
# floor (the coarsest head's one-value bias gradient is a sum that
# cancels). The step's gradient amplifies rounding (a warped pixel of a
# flat block one ulp either side of its target flips the SSIM clip's
# derivative): phase 11 logs, beside the card's reading, the CPU's step
# against itself with every weight one ulp away. A zeroed tensor reads
# 1.0, a sign-flipped one 2.0.
HARDEN_GRAD_L2, HARDEN_GRAD_L2_ALL, HARDEN_GRAD_FLOOR = 0.1, 1e-2, 1e-3


def harden_launches(iterations: int, temporal: int = 0,
                    bf16: bool = False) -> dict:
    """Kernel launches of one hardening step whose L0 attack ran
    `iterations` Adam iterations, with `temporal` temporal source frames,
    the student in bf16 or float32 (the teacher and the pose networks are
    float32): warp A (float32) forward in each iteration's view and twice
    in the synthesis (the pair, the other eye), its adjoint in each
    iteration; the student's stem pool forward in each attack pass, the
    student's forward and the benign encode, its backward in each attack
    pass and through both student passes; float32 B in the teacher's
    forward and in each pose-encoder pass, forward and backward; C in the
    photometric loss, an identity and 4 scales forward and 4 backward for
    each source frame; the student's D in its 4 scale-0 convs forward and
    input gradient in each attack pass and in its 6 (the scale-0 path and
    dispconv_1, _2) forward and input gradient; float32 D in the
    teacher's 4 convs forward."""
    i, t = iterations, temporal
    sfx = "_bf16" if bf16 else ""
    out = {k.name: 0 for k in _build.KERNELS}
    out.update({"vertical_resample_fwd": i + 2, "vertical_resample_bwd": i,
                "maxpool3x3s2_fwd": 1 + t, "maxpool3x3s2_bwd": t,
                "reproj_loss_fwd": 5 * (1 + t),
                "reproj_loss_bwd_q": 4 * (1 + t),
                "reproj_loss_bwd_grad": 4 * (1 + t), "conv3x3_fwd": 4})
    for name, n in (("maxpool3x3s2_fwd", i + 2), ("maxpool3x3s2_bwd", i + 2),
                    ("conv3x3_fwd", 4 * i + 6), ("conv3x3_dgrad", 4 * i + 6)):
        out[name + sfx] += n
    return out


def run_hardening_steps(label, trainer, inputs, warmup, timed):
    """`warmup` + `timed` `train_step`s of `trainer` on `inputs` (frames,
    sides, flips, scene) with every launch counter reset before the timed
    ones and read after: logs seconds per step, peak memory, each step's
    L0 iterations and early break, the loss terms and the launches beside
    `harden_launches` of the iterations; fails unless the launches are
    the predicted ones, the loss terms finite and complete, and every
    parameter and running statistic of the state's modules moved. Returns
    (state, launches)."""
    cfg = trainer.cfg
    frames, side, flip, scene = inputs
    dev = trainer.device
    state = trainer.make_state()
    start = {k: v.clone() for k, v in _state_tensors(state).items()}
    metrics, iters = [], []
    for n in range(warmup + timed):
        if n == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
            t0 = time.perf_counter()
        state, m = trainer.train_step(state, frames, side, flip, scene)
        metrics.append(m)
        iters.append((trainer.attack.last_iterations,
                      trainer.attack.last_early_break))
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / timed
    launches = {k.name: k.launches for k in _build.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    predicted = {k.name: 0 for k in _build.KERNELS}
    for n_it, _ in iters[warmup:]:
        for k, v in harden_launches(
                n_it, len(cfg.selfsup.temporal_source_ids),
                cfg.compute_dtype == "bfloat16").items():
            predicted[k] += v
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    log(f"  seconds per step {secs:.4f} (host clock around {timed} steps "
        f"after {warmup} warm-up, synchronised)")
    log(f"  max_memory_allocated {peak} B")
    log(f"  L0 iterations and early break per step {json.dumps(iters)}")
    log(f"  losses {json.dumps(losses)}")
    log(f"  launches {json.dumps(launches)}")
    log(f"  predicted from the code and the iterations "
        f"{json.dumps(predicted)}")
    if launches != predicted:
        raise AssertionError(f"phase {label}'s kernels did not launch as "
                             "predicted")
    expect = {"sup_loss", "contras_loss", "selfsup_loss", "loss"}
    if not all(math.isfinite(v) for m in losses for v in m.values()) or \
            any(set(m) != expect for m in losses):
        raise AssertionError(f"non-finite or missing loss terms: {losses}")
    moved = set(_moved(start, _state_tensors(state)))
    params = [n for n, _ in _named_params(state)]
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]
    still = (set(params) | set(stats)) - moved
    if still or state.step != warmup + timed:
        raise AssertionError(f"not moved: {sorted(still)[:5]}; step "
                             f"{state.step}")
    log(f"  moved: all {len(params)} parameters of "
        f"{'/'.join(state.modules())} and {len(stats)} running statistics; "
        f"step {state.step}")
    return state, launches


def log_kernel_ms(by_name, counts) -> None:
    """Device ms and launches of each kernel instance in a profile, and
    the top 15 kernels by device ms."""
    for kernel, marks in KERNEL_NAMES.items():
        hit = [name for name in by_name if any(m in name for m in marks)]
        log(f"  kernel {kernel}: {sum(by_name[n] for n in hit):.3f} device "
            f"ms of the step in {sum(counts[n] for n in hit)} launches")
    log("  device ms of the step by kernel (top 15):")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"    {ms:9.3f}  {k[:110]}")


def _harden_trainer(dev, cfg, sd, obj, mask, seed):
    """Student and frozen teacher from the golden weights (--fine-tune);
    the SimSiam head from `seed`."""
    teacher = make_monodepth2()
    teacher.load_state_dict(sd)
    return HardeningTrainer(cfg, torch.Generator().manual_seed(seed), obj,
                            mask, predictor_from(teacher.to(dev)),
                            device=dev, init_state_dict=sd)


def _harden_inputs(dev, cfg, seed):
    """Synthetic 375x1242 frames ("s" is "0" shifted by 12 columns; the
    temporal frames, where configured, "0" shifted by 8 columns ("-1") and
    by 6 rows ("1")), sides and flips mixed over the batch, and one scene
    for the attack."""
    B = cfg.batch_size
    f0 = torch.from_numpy(make_scene(B, cfg.adv.ori_h, cfg.adv.ori_w,
                                     seed=seed))
    frames = {"0": f0.to(dev), "s": torch.roll(f0, 12, dims=2).to(dev)}
    shifts = {"-1": (8, 2), "1": (6, 1)}
    for fid in cfg.selfsup.temporal_source_ids:
        n, dim = shifts[fid]
        frames[fid] = torch.roll(f0, n, dims=dim).to(dev)
    side = torch.arange(B, device=dev) % 2 == 0
    flip = torch.arange(B, device=dev) % 4 < 2
    scene = torch.from_numpy(make_scene(1, cfg.adv.ori_h, cfg.adv.ori_w,
                                        seed=seed + 1)).to(dev)
    return frames, side, flip, scene


def _state_tensors(state):
    """Every weight and statistic of the state's trained modules (the
    student, the SimSiam head, the pose networks), by "<module>.<name>"."""
    return {f"{key}.{k}": v for key, m in state.modules().items()
            for k, v in m.state_dict().items()}


def phase_harden(dev):
    """The hardening step at config 4; returns the launch counts of the
    timed steps."""
    phase_harden_parity(dev)
    cfg = HARDEN_CFG
    B = cfg.batch_size
    _, sd = _golden_weights()
    obj, mask = make_car_object(300, 200, seed=SEED)
    frames, side, flip, scene = _harden_inputs(dev, cfg, SEED + 70)
    trainer = _harden_trainer(dev, cfg, sd, obj, mask, SEED + 71)
    log(f"harden: HardeningTrainer.train_step at config 4: Monodepth2-"
        f"{cfg.num_layers} student and teacher from the golden weights, "
        f"{cfg.selfsup.width}x{cfg.selfsup.height} f32, scales "
        f"{cfg.selfsup.scales}, frames {cfg.selfsup.frame_ids}, L0 attack "
        f"steps {cfg.adv.steps} (up to {2 * cfg.adv.steps} iterations) on "
        f"attack batch {cfg.adv.attack_batch_size}, supervised + "
        f"contrastive + photometric, batch {B} of {cfg.adv.ori_w}x"
        f"{cfg.adv.ori_h} frames, car 300x200, Adam lr {cfg.learning_rate}")
    state, launches = run_hardening_steps(
        "11", trainer, (frames, side, flip, scene), HARDEN_WARMUP,
        HARDEN_TIMED)
    phase_harden_breakdown(trainer, state, frames, side, flip, scene)
    del state, trainer
    torch.cuda.empty_cache()
    phase_harden_eval(dev, sd, obj, mask)
    phase_harden_distill(dev, sd, obj, mask)
    return launches


def phase_harden_breakdown(trainer, state, frames, side, flip, scene):
    """Median CUDA-event ms of the three parts `train_step` runs (3
    steps), the L0 attack's ms an iteration, then one whole step under
    the profiler: idle share and device ms by kernel."""
    cfg = HARDEN_CFG
    names = ("attack (refresh_texture: the L0 loop)", "synthesis "
             "(synth_batch: 375x1242 pair and other eye, resize)",
             "update (_update: student, teacher, benign encode, SimSiam, "
             "photometric loss, backward, Adam)")
    times = {n: [] for n in names}
    per_iter = []
    for _ in range(3):
        draws = trainer.draw(cfg.batch_size)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        obj_adv = trainer.refresh_texture(state, scene, draws)
        ev[1].record()
        batch = trainer.synth_batch(frames, side, flip, obj_adv, draws)
        ev[2].record()
        state, _ = trainer._update(state, batch, draws.identity_noise)
        ev[3].record()
        ev[3].synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
        per_iter.append(ev[0].elapsed_time(ev[1])
                        / max(trainer.attack.last_iterations, 1))
    log(f"harden breakdown at batch {cfg.batch_size}, {cfg.selfsup.width}x"
        f"{cfg.selfsup.height} (median CUDA-event ms of 3):")
    for n in names:
        log(f"  {n}: {float(np.median(times[n])):.3f}")
    log(f"  L0 attack ms an iteration (attack batch "
        f"{cfg.adv.attack_batch_size}): {float(np.median(per_iter)):.3f}")
    busy_ms, wall_ms, n, by_name, counts = device_busy(
        lambda: trainer.train_step(state, frames, side, flip, scene))
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    log_kernel_ms(by_name, counts)


def _l2_with_floor(got, want, floor):
    """(worst per-tensor, its name, overall) relative L2 error of the
    tensors of `got` to `want` (dicts), each relative to the larger of
    its norm and `floor` times the largest tensor norm."""
    big = max(float(w.double().norm()) for w in want.values())
    worst, name_, num, den = 0.0, None, 0.0, 0.0
    for name, w in want.items():
        w = w.double()
        err = float((got[name].detach().cpu().double() - w).norm())
        ref = float(w.norm())
        if err / max(ref, floor * big) > worst:
            worst, name_ = err / max(ref, floor * big), name
        num, den = num + err ** 2, den + ref ** 2
    return worst, name_, (num / den) ** 0.5


def phase_harden_parity(dev, frame_ids=("0", "s")) -> None:
    """One small hardening step (the model at 64x192, 96x320 frames, a
    24x36 car, batch 4, attack batch 2, L0 steps=2; `frame_ids`: with
    temporal ones, the pose networks' gradients too) on the card and on
    the CPU's plain versions, from the same weights and draws: the L0
    loop's iteration count and its first iteration's gradients (rtol
    1e-3, atol 1e-3 of their largest magnitude: Adam turns rounding at
    near-zero gradients into moves of up to lr, so the trajectories
    part, as the CPU tests show against JAX); the synthesis from the
    CPU's texture within 1e-5; then the training half on the CPU's
    batch: each loss term within 1e-5 relative (contrastive 1e-5
    absolute), the student's and the head's gradients within
    HARDEN_GRAD_L2 per tensor and HARDEN_GRAD_L2_ALL overall, parameters
    within 2.5 lr (on a first Adam step each parameter moves by less
    than lr on either side, so this rule catches only NaN and infinity).
    Beside it, the CPU's step against itself with every weight one ulp
    away: the scale of the rounding the step amplifies."""
    ss = dataclasses.replace(HARDEN_CFG.selfsup, height=64, width=192,
                             frame_ids=frame_ids)
    adv = dataclasses.replace(HARDEN_CFG.adv, steps=2, attack_batch_size=2,
                              ori_h=96, ori_w=320)
    cfg = dataclasses.replace(HARDEN_CFG, selfsup=ss, adv=adv, batch_size=4,
                              learning_rate=CONVERGE_LR)
    _, sd = _golden_weights()
    obj, mask = make_car_object(36, 24, seed=SEED)
    frames, side, flip, scene = _harden_inputs(torch.device("cpu"), cfg,
                                               SEED + 72)
    cpu_dev = torch.device("cpu")
    trainers = [_harden_trainer(d, cfg, sd, obj, mask, SEED + 73)
                for d in (cpu_dev, dev)]
    draws = trainers[0].draw(cfg.batch_size,
                             torch.Generator().manual_seed(SEED + 74))
    draws.identity_noise = torch.randn(
        (cfg.batch_size, ss.height, ss.width, len(ss.source_frame_ids)),
        generator=torch.Generator().manual_seed(SEED + 75))
    states = [t.make_state() for t in trainers]
    texs, grads, iters = [], [], []
    for t, st in zip(trainers, states):
        texs.append(t.refresh_texture(st, scene.to(t.device), draws).cpu())
        atk = t.attack
        iters.append(atk.last_iterations)
        full = atk._replicate(scene.to(t.device), 2)
        d = draws.attack
        _, g = atk.cost_and_grads(full, d.pos.to(t.device),
                                  d.neg.to(t.device), d.z0s[0], d.alphas[0],
                                  atk.mask_wt)
        grads.append([x.cpu() for x in g])
    g_err = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(grads[1], grads[0]))
    split = float(((texs[1] - texs[0]).abs() > 1e-4).float().mean())
    batches = []
    for t in trainers:
        to = lambda v: v.to(t.device)
        batches.append(t.synth_batch({k: to(v) for k, v in frames.items()},
                                     to(side), to(flip), to(texs[0]), draws))
    s_err = max(float((batches[1][k].cpu() - batches[0][k]).abs().max())
                for k in ("color_ben", "objmask"))
    s_err = max([s_err] + [float((batches[1][g][f].cpu()
                                  - batches[0][g][f]).abs().max())
                           for g in ("color", "color_aug")
                           for f in frame_ids])
    cpu_batch = batches[0]
    nudged = trainers[0].make_state()
    nudged.model.load_state_dict(_ulp_nudged(nudged.model.state_dict(),
                                             SEED + 76))
    out = []
    for t, st in zip(trainers + trainers[:1], states + [nudged]):
        batch = {k: ({f: v.to(t.device) for f, v in x.items()}
                     if isinstance(x, dict) else x.to(t.device))
                 for k, x in cpu_batch.items()}
        st, m = t._update(st, batch, draws.identity_noise.to(t.device))
        out.append(({k: float(v) for k, v in m.items()}, st))
    (m_cpu, s_cpu), (m_gpu, s_gpu), (_, s_ulp) = out
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    g_cpu = {n: p.grad for n, p in _named_params(s_cpu)}
    g_gpu = {n: p.grad for n, p in _named_params(s_gpu)}
    gw, gw_name, ga = _l2_with_floor(g_gpu, g_cpu, HARDEN_GRAD_FLOOR)
    uw, uw_name, ua = _l2_with_floor(
        {n: p.grad for n, p in _named_params(s_ulp)}, g_cpu,
        HARDEN_GRAD_FLOOR)
    worst = max(float((p.detach().cpu() - q.detach()).abs().max())
                for (_, p), (_, q) in zip(_named_params(s_gpu),
                                          _named_params(s_cpu)))
    lr = cfg.learning_rate
    log(f"harden parity: one step at 64x192 batch 4, frames {frame_ids}, "
        f"L0 steps 2 on attack batch 2: iterations card {iters[1]} CPU {iters[0]}, first "
        f"iteration's gradients {g_err:.3e} of their max, textures split "
        f"{split:.4%} (logged: the trajectories part); synthesis from the "
        f"CPU's texture {s_err:.3e}; on the CPU's batch: losses "
        f"{json.dumps(m_gpu)} vs {json.dumps(m_cpu)} (rel "
        f"{json.dumps(rel)}), gradient rel L2 {gw:.3e} worst tensor "
        f"({gw_name}), {ga:.3e} overall, max |param difference| "
        f"{worst / lr:.3f} lr; the CPU against itself with every weight "
        f"one ulp away: {uw:.3e} worst tensor ({uw_name}), {ua:.3e} overall")
    limits = {"L0 iterations": (abs(iters[0] - iters[1]), 0),
              "first iteration's gradients": (g_err, 1e-3),
              "synthesis": (s_err, 1e-5),
              "contrastive loss": (abs(m_gpu["contras_loss"]
                                       - m_cpu["contras_loss"]), 1e-5),
              "gradient, worst tensor": (gw, HARDEN_GRAD_L2),
              "gradient, overall": (ga, HARDEN_GRAD_L2_ALL),
              "parameters": (worst, 2.5 * lr)}
    limits.update({f"{k} (rel)": (rel[k], 1e-5) for k in rel
                   if k != "contras_loss"})
    bad = {k: v for k, (v, lim) in limits.items() if not v <= lim}
    if bad:
        raise AssertionError(f"the card's hardening step disagrees with the "
                             f"plain versions on the CPU: {bad}")


def _ulp_nudged(sd, seed):
    """`sd` with every float moved one ulp up or down at random."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            up = torch.randint(0, 2, v.shape, generator=gen).bool()
            v = torch.nextafter(v, torch.where(up, math.inf, -math.inf))
        out[k] = v
    return out


def _named_params(state):
    return [(f"{key}.{n}", p) for key, m in state.modules().items()
            for n, p in m.named_parameters()]


def phase_harden_eval(dev, sd, obj, mask) -> None:
    """One untimed L0 attack-eval batch (`eval-attacks`' default norm)
    through build_attack + evaluate_attacks, batch 12, 10 steps."""
    cfg = AttackEvalConfig(norm_type="l_0", step=10, batch_size=12,
                           eval_count=1)
    model = make_monodepth2()
    model.load_state_dict(sd)
    predictor = predictor_from(model.to(dev))
    attack = build_attack(cfg, predictor, obj, mask)
    scenes = make_scene(cfg.batch_size, cfg.ori_h, cfg.ori_w, seed=SEED + 80)
    t0 = time.perf_counter()
    res = evaluate_attacks(predictor, attack, [scenes], cfg,
                           generator=torch.Generator().manual_seed(SEED + 81))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"L0 eval: build_attack(l_0) + evaluate_attacks, batch "
        f"{cfg.batch_size}, {cfg.step} steps: {attack.last_iterations} "
        f"iterations, early break {attack.last_early_break}, {secs:.4f} s "
        f"(untimed batch, host clock), metrics mean "
        f"{json.dumps(res['mean'])}")
    vals = list(res["mean"].values()) + list(res["max"].values())
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite L0 eval metrics: {res}")


def phase_harden_distill(dev, sd, obj, mask) -> None:
    """One untimed distillation step with adv_type "object_l0" (config
    3b) at batch 32."""
    cfg = DistillConfig(adv_type="object_l0", batch_size=32)
    trainer = _distill_trainer(dev, cfg, sd, obj, mask, SEED + 82)
    scenes = torch.from_numpy(make_scene(cfg.batch_size, cfg.ori_h,
                                         cfg.ori_w, seed=SEED + 83)).to(dev)
    state = trainer.make_state()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, scenes)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"L0 distill: DistillTrainer.train_step, adv_type object_l0, batch "
        f"{cfg.batch_size}: {trainer.attack.last_iterations} iterations, "
        f"early break {trainer.attack.last_early_break}, loss "
        f"{float(m['loss']):.6e}, {secs:.4f} s (untimed step, host clock)")
    if not math.isfinite(float(m["loss"])) or state.step != 1:
        raise AssertionError("the L0 distillation step failed")


# -- phase 12 ----------------------------------------------------------------
# the CLI's `train-hardening --fine-tune` defaults as they are (cli/main.py:
# 594-656): compute dtype bfloat16 (the student; the teacher is the CLI's
# float32 predictor), frames ("0", "s"), L0 with 10 steps on attack batch
# 12, batch 32, lr 1e-5, supervised + contrastive + photometric; 12b adds
# --frame-ids 0,-1,1,s (mono+stereo: the float32 pose networks)
CLI_CFG = dataclasses.replace(HARDEN_CFG, compute_dtype="bfloat16")
MONO_FRAMES = ("0", "-1", "1", "s")
CLI_RUNS = (("12a", ("0", "s")), ("12b", MONO_FRAMES))
CLI_WARMUP, CLI_TIMED = 2, 3
# the small bf16 step on the card against the CPU's is held to phase 10's
# rule (BENCH_LOSS_RTOL, BENCH_GRAD_L2_ALL) on phase 10's kind of step:
# the teacher's MSE through the bf16 student, seeded as phase 10's (a
# student equal to the teacher leaves the MSE a difference of near-equal
# predictions that bf16 rounding decides). The photometric and
# contrastive branches are logged, not held: in bf16 at this size the
# CPU's step against itself one ulp away moves their gradients by about
# as much as the rule allows (0.1147 with the photometric branch, 0.8626
# with SimSiam's BatchNorm1d over 4 samples too, on an H100 80GB HBM3 at
# 700 W), so no rule there tells a fault from bf16's rounding
CLI_PARITY_SEED = SEED + 93


def _cli_cfg(frame_ids):
    return dataclasses.replace(CLI_CFG, selfsup=dataclasses.replace(
        CLI_CFG.selfsup, frame_ids=frame_ids))


def phase_cli(dev):
    """Phase 12: the CLI's bf16 hardening step, 12a with frames ("0", "s")
    and 12b mono+stereo; returns the launch counts of their timed steps,
    summed."""
    _, sd = _golden_weights()
    cal = calibrated_teacher(dev, sd)
    phase_cli_bf16_parity(dev, cal)
    phase_harden_parity(dev, MONO_FRAMES)
    obj, mask = make_car_object(300, 200, seed=SEED)
    total = {}
    for label, frame_ids in CLI_RUNS:
        cfg = _cli_cfg(frame_ids)
        trainer = _harden_trainer(dev, cfg, cal, obj, mask, SEED + 90)
        inputs = _harden_inputs(dev, cfg, SEED + 91)
        state, launches = phase_cli_run(label, trainer, inputs)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if label == "12a":
            phase_cli_checkpoint(dev, cfg, cal, obj, mask, trainer, state,
                                 inputs)
        else:
            phase_cli_pose_eval(dev, state)
        del state, trainer
        torch.cuda.empty_cache()
    return total


def phase_cli_run(label, trainer, inputs):
    """CLI_WARMUP + CLI_TIMED steps (`run_hardening_steps`), then one
    profiled step: idle share and device ms by kernel instance. Returns
    (state, launches)."""
    cfg = trainer.cfg
    log(f"cli {label}: HardeningTrainer.train_step at the CLI's "
        f"train-hardening --fine-tune defaults: Monodepth2-"
        f"{cfg.num_layers} student in {cfg.compute_dtype} and float32 "
        f"teacher from the golden weights (statistics calibrated), "
        f"{cfg.selfsup.width}x{cfg.selfsup.height}, frames "
        f"{cfg.selfsup.frame_ids}, L0 steps {cfg.adv.steps} on attack batch "
        f"{cfg.adv.attack_batch_size}, supervised + contrastive + "
        f"photometric, batch {cfg.batch_size} of {cfg.adv.ori_w}x"
        f"{cfg.adv.ori_h} frames, car 300x200, Adam lr {cfg.learning_rate}")
    state, launches = run_hardening_steps(label, trainer, inputs,
                                          CLI_WARMUP, CLI_TIMED)
    busy_ms, wall_ms, n, by_name, counts = device_busy(
        lambda: trainer.train_step(state, *inputs))
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities, "
        f"{trainer.attack.last_iterations} L0 iterations")
    log_kernel_ms(by_name, counts)
    return state, launches


def phase_cli_bf16_parity(dev, teacher_sd) -> None:
    """One small bf16 hardening step (frames ("0", "s"), the model at
    64x192, 96x320 frames, a 24x36 car, batch 4, L0 steps 2 on attack
    batch 2; the student from a seeded init, the teacher float32 from
    `teacher_sd`) on the card and on the CPU's plain versions, from the
    same weights and draws: the L0 iterations and the textures' split
    logged; the training half on the CPU's batch with the supervised
    branch (phase 10's kind of step: the teacher's MSE through the bf16
    student) within phase 10's rule (loss BENCH_LOSS_RTOL relative,
    gradients BENCH_GRAD_L2_ALL overall). Logged beside it, for the
    supervised branch, with the photometric one added and with the
    contrastive one too: the card against the CPU and the CPU's step
    against itself with every weight one ulp away (the scale of the
    rounding each step amplifies)."""
    ss = dataclasses.replace(CLI_CFG.selfsup, height=64, width=192)
    adv = dataclasses.replace(CLI_CFG.adv, steps=2, attack_batch_size=2,
                              ori_h=96, ori_w=320)
    cfg = dataclasses.replace(CLI_CFG, selfsup=ss, adv=adv, batch_size=4,
                              learning_rate=CONVERGE_LR)
    obj, mask = make_car_object(36, 24, seed=SEED)
    cpu = torch.device("cpu")
    frames, side, flip, scene = _harden_inputs(cpu, cfg, SEED + 92)

    def trainer_on(d, c):
        teacher = make_monodepth2()
        teacher.load_state_dict(teacher_sd)
        return HardeningTrainer(c, torch.Generator().manual_seed(
            CLI_PARITY_SEED), obj, mask, predictor_from(teacher.to(d)),
            device=d)

    trainers = [trainer_on(d, cfg) for d in (cpu, dev)]
    draws = trainers[0].draw(cfg.batch_size,
                             torch.Generator().manual_seed(SEED + 94))
    draws.identity_noise = torch.randn(
        (cfg.batch_size, ss.height, ss.width, 1),
        generator=torch.Generator().manual_seed(SEED + 95))
    texs, iters = [], []
    for t in trainers:
        texs.append(t.refresh_texture(t.make_state(), scene.to(t.device),
                                      draws).cpu())
        iters.append(t.attack.last_iterations)
    split = float(((texs[1] - texs[0]).abs() > 1e-4).float().mean())
    batch = trainers[0].synth_batch(frames, side, flip, texs[0], draws)

    def grads(t, nudge=False):
        st = t.make_state()
        if nudge:
            st.model.load_state_dict(_ulp_nudged(st.model.state_dict(),
                                                 SEED + 96))
        b = {k: ({f: v.to(t.device) for f, v in x.items()}
                 if isinstance(x, dict) else x.to(t.device))
             for k, x in batch.items()}
        st, m = t._update(st, b, draws.identity_noise.to(t.device))
        return float(m["loss"]), {n: p.grad for n, p in _named_params(st)
                                  if p.grad is not None}

    readings = {}
    for name, kw in (("supervised", dict(no_original_train=True,
                                         contrastive_learning=False)),
                     ("+ photometric", dict(contrastive_learning=False)),
                     ("+ contrastive", {})):
        c = dataclasses.replace(cfg, **kw)
        (l_cpu, g_cpu), (l_gpu, g_gpu) = (
            grads(trainer_on(d, c)) for d in (cpu, dev))
        if set(g_cpu) != set(g_gpu):
            raise AssertionError("the card and the CPU differ in which "
                                 "parameters got a gradient")
        _, g_ulp = grads(trainer_on(cpu, c), nudge=True)
        readings[name] = (abs(l_gpu - l_cpu) / abs(l_cpu), l_gpu,
                          _l2_with_floor(g_gpu, g_cpu, 0.0)[2],
                          _l2_with_floor(g_ulp, g_cpu, 0.0)[2])
    log(f"cli bf16 parity: one bf16 step at 64x192 batch 4, frames "
        f"{ss.frame_ids}, L0 steps 2 on attack batch 2, seeded student, "
        f"float32 teacher: iterations card {iters[1]} CPU {iters[0]}, "
        f"textures split {split:.4%} (logged); on the CPU's batch, card "
        f"against CPU: loss rel, gradient rel L2 overall; the CPU against "
        f"itself with every weight one ulp away:")
    for name, (rel, loss, g_all, ulp) in readings.items():
        log(f"  {name}: loss {loss:.8e} rel {rel:.3e}, gradients {g_all:.3e};"
            f" one ulp away {ulp:.3e}")
    rel, loss, g_all, _ = readings["supervised"]
    log(f"  held: supervised, loss rel max {BENCH_LOSS_RTOL}, gradients max "
        f"{BENCH_GRAD_L2_ALL}")
    if rel > BENCH_LOSS_RTOL or not g_all <= BENCH_GRAD_L2_ALL or \
            not math.isfinite(loss):
        raise AssertionError("the card's bf16 hardening step disagrees with "
                             "the plain versions on the CPU")


def phase_cli_checkpoint(dev, cfg, teacher_sd, obj, mask, trainer, state,
                         inputs) -> None:
    """`save_state` after 12a, `restore_state` into a fresh trainer (of
    another seed): parameters, statistics, Adam's moments and counts, the
    step and the generators' states `torch.equal` to the saved ones; the
    next step on the same injected draws gives the restored trainer the
    continuing trainer's loss within 1e-6 relative."""
    ckpt_dir = os.path.join(REPO, "build", "ckpt_smoke")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    path = checkpoints.save_state(ckpt_dir, state.step, state,
                                  trainer=trainer)
    fresh = _harden_trainer(dev, cfg, teacher_sd, obj, mask, SEED + 97)
    restored = checkpoints.restore_state(ckpt_dir, fresh.make_state(),
                                         trainer=fresh)
    secs = time.perf_counter() - t0

    def tensors(t, s):
        out = dict(_state_tensors(s))
        for i, st in enumerate(s.optimizer.state.values()):
            out.update({f"adam.{i}.{k}": v for k, v in st.items()})
        out["generator"] = t.generator.get_state()
        out["noise_generator"] = t.noise_generator.get_state()
        return out

    want, got = tensors(trainer, state), tensors(fresh, restored)
    differ = [k for k in want if k not in got
              or not torch.equal(got[k], want[k])]
    draws = trainer.draw(cfg.batch_size,
                         torch.Generator().manual_seed(SEED + 98))
    draws.identity_noise = trainer.draw_identity_noise(cfg.batch_size)
    losses = []
    for t, s in ((trainer, state), (fresh, restored)):
        _, m = t.train_step(s, *inputs, draws=draws)
        losses.append(float(m["loss"]))
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    log(f"cli checkpoint: save_state + restore_state of step {state.step} "
        f"({size} B, {secs:.3f} s on the host): {len(want)} tensors and "
        f"generator states, {len(differ)} differ; next step's loss "
        f"continuing {losses[0]:.8e} restored {losses[1]:.8e} (rel "
        f"{rel:.3e}, max 1e-6)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if differ or set(got) != set(want) or rel > 1e-6 or \
            restored.step != state.step:
        raise AssertionError(f"the checkpoint round trip is not exact: "
                             f"{differ[:5]}, loss rel {rel}")


def phase_cli_pose_eval(dev, state) -> None:
    """`predict_pair_poses` of 12b's pose networks on 16 synthetic
    1024x320 pairs on the card and on the CPU (within 1e-4 absolute),
    and `trajectory_ates` of the card's against a synthetic ground truth
    (a car driving about 1 m a frame with a slow yaw)."""
    frames = make_scene(17, 320, 1024, seed=SEED + 99)
    pairs = [np.concatenate([frames[i:i + 1], frames[i + 1:i + 2]], -1)
             for i in range(16)]
    t0 = time.perf_counter()
    got = pose_eval.predict_pair_poses(state.pose_encoder,
                                       state.pose_decoder, pairs, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = pose_eval.predict_pair_poses(state.pose_encoder,
                                        state.pose_decoder, pairs,
                                        device="cpu")
    err = float(np.abs(got - want).max())
    gt = [np.eye(4)]
    for i in range(16):
        T = np.eye(4)
        a = 0.01 * math.sin(i / 3.0)
        T[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]]
        T[:3, 3] = [0.02 * math.cos(i), 0.0, 1.0]
        gt.append(gt[-1] @ T)
    mean, std, ates = pose_eval.trajectory_ates(
        got, np.stack([g[:3] for g in gt]))
    log(f"cli pose eval: predict_pair_poses on 16 pairs at 1024x320: card "
        f"{secs:.4f} s (host clock, untimed first call), card vs CPU max "
        f"|difference| {err:.3e} (max 1e-4); trajectory_ates on the "
        f"synthetic ground truth: mean {mean:.6e} std {std:.6e} over "
        f"{len(ates)} windows")
    if not err <= 1e-4 or not (math.isfinite(mean) and math.isfinite(std)):
        raise AssertionError("pose eval failed")


# -- phase 13 ----------------------------------------------------------------
# the reference's evaluation zoo (evaluate_depth.py:403-517): every norm
# type of build_attack, the 16 presets, the clean eval and the sweeps
ZOO_SMALL = dict(scene_h=96, scene_w=320, batch_size=2, eval_count=1)
# 13a's attacks, each (label, AttackEvalConfig fields, 200x300 car): the
# painted region (rows 90:170, cols 100:200) needs the big car
ZOO_PARITY = (
    ("l_2", dict(norm_type="l_2", epsilon=1.0, step=2), False),
    ("APGD", dict(norm_type="APGD", epsilon=0.05, step=3), False),
    ("image", dict(norm_type="image", epsilon=0.01, alpha=0.002, step=2),
     False),
    ("Square", dict(norm_type="Square", epsilon=0.1, n_queries=24), False),
    ("light", dict(norm_type="light", n_inits=3, n_neighbors=2), False),
    ("guassian", dict(norm_type="guassian", step=4), True),
    ("arbi", dict(norm_type="arbi"), True),
    ("vanila", dict(norm_type="vanila"), False),
    ("physical", dict(norm_type="physical"), False),
)
# the card against the CPU: a start gradient by the CPU tests' gradient
# rule (rtol 1e-3, atol 1e-3 of the max); the searches' best cost within
# ZOO_COST_RTOL relative (kernel D sums in another order than the CPU's
# im2col + SGEMM: 1e-5 of a conv's output, CONV_RTOL), their winner and
# texture equal (1e-6) unless the two winners' costs lie within that
# rule on both devices (a near-tie: both costs are logged); L2's texture
# 1e-4 (tests/test_torch_attacks_whitebox.py); the finals of one texture
# 1e-5, their 8 metrics rtol 1e-3, atol 1e-3 (the CPU tests' rule)
ZOO_GRAD_RTOL = 1e-3
ZOO_COST_RTOL = 1e-4
ZOO_FINALS_ATOL = 1e-5
ZOO_METRIC_TOL = 1e-3
# 13b: the presets at full width, one batch each; Square and light cut to
# these lengths (the p schedule rescales to n_queries, so a cut run walks
# it whole), the idle share from a shorter run of each
ZOO_SQUARE_QUERIES = 400
ZOO_LIGHT = (20, 10)  # n_inits x n_neighbors x 2 = 400 candidates
ZOO_PROFILE = dict(Square=dict(n_queries=100),
                   light=dict(n_inits=5, n_neighbors=10))
ZOO_KERNELS = SLICE1_KERNELS


def zoo_launches(cfg, iterations: int = 0) -> dict:
    """Predicted launches of one evaluate_attacks batch of `cfg` (eval
    mode: the finals take the exact warp, no kernel A): each model
    forward launches B1 once and D 4 times (the scale-0 path's <= 64
    channel convs), each input gradient B2 once and D's dgrad 4 times;
    each tiled EoT view A1 once, and A2 where it is differentiated; the
    metrics add 2 forwards. `iterations`: the L0 attack's."""
    nt, n = cfg.norm_type, cfg.step
    per = {  # (views, differentiated views, forwards, input gradients)
        "l_0": (iterations, iterations, iterations, iterations),
        "l_inf": (n, n, n, n), "l_2": (n, n, n, n),
        "APGD": (n + 1, n + 1, n + 1, n + 1),
        "image": (0, 0, n, n),
        "Square": (cfg.n_queries + 1, 0, cfg.n_queries + 1, 0),
        "light": (2 * cfg.n_inits * cfg.n_neighbors, 0,
                  2 * cfg.n_inits * cfg.n_neighbors, 0),
        "guassian": (n, 0, n, 0),
    }.get(nt, (0, 0, 0, 0))
    views, dviews, fwd, bwd = per
    fwd += 2
    return {"vertical_resample_fwd": views, "vertical_resample_bwd": dviews,
            "maxpool3x3s2_fwd": fwd, "maxpool3x3s2_bwd": bwd,
            "conv3x3_fwd": 4 * fwd, "conv3x3_dgrad": 4 * bwd}


def _golden_predictor(dev, sd):
    model = make_monodepth2()
    model.load_state_dict(sd)
    return predictor_from(model.to(dev))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_zoo(dev):
    """Phase 13; returns the launches of 13b's 16 presets, summed."""
    _, sd = _golden_weights()
    t0 = time.perf_counter()
    phase_zoo_parity(dev, sd)
    log(f"  [13a: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    launches = phase_zoo_presets(dev, sd)
    log(f"  [13b: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    phase_zoo_surface(dev, sd)
    log(f"  [13c: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    phase_zoo_distill(dev, sd)
    log(f"  [13d: {time.perf_counter() - t0:.1f} s]")
    return launches


def phase_zoo_parity(dev, sd) -> None:
    """13a: each attack of the zoo the port added in slice 6a, small
    (96x320, batch 2, the golden weights, a 40x60 car or the 200x300 one,
    375x1242 scenes), once on the card and once on the CPU's plain
    versions from the same draws: the start gradient of the white-box
    attacks, the searches' winner, best cost and texture, L2's texture,
    the other textures logged; the finals and the metrics of the CPU's
    texture on both."""
    cpu = torch.device("cpu")
    preds = {d: _golden_predictor(d, sd) for d in (cpu, dev)}
    scenes = {d: torch.from_numpy(make_scene(2, 375, 1242, seed=SEED + 120)
                                  ).to(d) for d in (cpu, dev)}
    log("zoo 13a: card against CPU at 96x320, batch 2, golden weights, "
        "injected draws (start gradient rtol/atol "
        f"{ZOO_GRAD_RTOL} of the max; best cost {ZOO_COST_RTOL} rel; "
        f"finals {ZOO_FINALS_ATOL}; metrics rtol/atol {ZOO_METRIC_TOL}):")
    for label, kw, big in ZOO_PARITY:
        obj, mask = make_car_object(300, 200) if big else \
            make_car_object(60, 40)
        given = np.clip(obj * 0.7 + 0.2, 0, 1) * (mask > 0)
        cfg = AttackEvalConfig(**ZOO_SMALL, **kw)
        atks = {d: build_attack(cfg, preds[d], obj, mask, adv_obj_img=given)
                for d in (cpu, dev)}
        draws = atks[cpu].draw(torch.Generator().manual_seed(SEED + 121), 2)
        notes = _zoo_pair(label, atks, preds, scenes, draws, given, cpu, dev)
        log(f"  {label}: {notes}")


def _zoo_pair(label, atks, preds, scenes, draws, given, cpu, dev) -> str:
    """One attack of 13a on both devices; returns its log line, raises on
    a disagreement."""
    notes = []
    if label == "image":
        x = {d: torch.clamp(bilinear_resize(scenes[d], 96, 320)
                            + draws.noise.to(d), 0.0, 1.0)
             .requires_grad_(True) for d in (cpu, dev)}
        g = {d: torch.autograd.grad(torch.mean(preds[d](x[d]) ** 2), x[d])[0]
             .cpu() for d in (cpu, dev)}
    elif label in ("l_2", "APGD"):
        start = _zoo_start(label, atks[cpu], draws)
        g = {d: atks[d].objective_and_grad(
            atks[d]._replicate(scenes[d], 2), start.to(d),
            draws.z0s[0] if label == "l_2" else draws.z0s,
            draws.alphas[0] if label == "l_2" else draws.alphas)[1].cpu()
             for d in (cpu, dev)}
    else:
        g = None
    if g is not None:
        scale = float(g[cpu].abs().max())
        err = float((g[dev] - g[cpu]).abs().max())
        notes.append(f"start gradient err {err / scale:.3e} of the max")
        if not torch.allclose(g[dev], g[cpu], rtol=ZOO_GRAD_RTOL,
                              atol=ZOO_GRAD_RTOL * scale):
            raise AssertionError(f"zoo {label}: start gradient disagrees")

    out = {}
    for d in (cpu, dev):
        atk = atks[d]
        if label == "image":
            out[d] = atk(scenes[d], draws=draws)[0].cpu()
        elif label == "vanila":
            out[d] = torch.from_numpy(given)
        else:
            out[d] = atk._optimize(atk._replicate(scenes[d], 2), draws).cpu()
    diff = float((out[dev] - out[cpu]).abs().max())
    split = float(((out[dev] - out[cpu]).abs() > 1e-6).float().mean())
    notes.append(f"result max |card - CPU| {diff:.3e}, {split:.4%} apart")
    if label in ("Square", "light", "guassian"):
        notes.append(_zoo_search_pair(label, atks, scenes, draws, out, cpu,
                                      dev))
    elif label == "l_2" and diff > 1e-4:
        raise AssertionError("zoo l_2: textures disagree")
    elif label in ("arbi", "vanila", "physical") and diff > 1e-6:
        raise AssertionError(f"zoo {label}: textures disagree")
    elif label == "APGD":
        st = {d: atks[d].last_state for d in (cpu, dev)}
        notes.append(f"step size card {float(st[dev]['step_size']):g} CPU "
                     f"{float(st[cpu]['step_size']):g}")
        if (st[dev]["k"], st[dev]["counter3"]) != (st[cpu]["k"],
                                                   st[cpu]["counter3"]):
            raise AssertionError("zoo APGD: schedule disagrees")

    # the finals and metrics of the CPU's result on both devices
    fin = {}
    for d in (cpu, dev):
        with torch.no_grad():
            if label == "image":
                ben = bilinear_resize(scenes[d], 96, 320)
                f = (out[cpu].to(d), ben, torch.ones_like(ben[..., :1]))
            else:
                f = atks[d]._final_outputs(
                    atks[d]._replicate(scenes[d], 2), out[cpu].to(d),
                    draws.final_z0s, draws.final_alphas, True)
            fin[d] = ([t.cpu() for t in f],
                      torch.stack(_batch_metrics(atks[d].predictor, *f))
                      .cpu().numpy())
    f_err = max(float((a - b).abs().max())
                for a, b in zip(fin[dev][0], fin[cpu][0]))
    m_ok = np.allclose(fin[dev][1], fin[cpu][1], rtol=ZOO_METRIC_TOL,
                       atol=ZOO_METRIC_TOL)
    fmt = lambda m: "[" + ", ".join(f"{v:.5f}" for v in m) + "]"
    notes.append(f"finals err {f_err:.3e}, metrics card {fmt(fin[dev][1])} "
                 f"CPU {fmt(fin[cpu][1])}")
    if f_err > ZOO_FINALS_ATOL or not m_ok or \
            not np.isfinite(fin[dev][1]).all():
        raise AssertionError(f"zoo {label}: finals or metrics disagree")
    return "; ".join(notes)


def _zoo_start(label, atk, draws):
    """The white-box attack's start texture on the CPU (L2: the first
    sample's random start; APGD: its L-inf start)."""
    if label == "l_2":
        delta = draws.delta * (draws.r / draws.delta.reshape(2, -1).norm(
            dim=1)).reshape(2, 1, 1, 1) * atk.eps
        return torch.clamp(atk.obj_img + delta, 0.0, 1.0)
    return torch.clamp(atk.obj_img + atk.eps * draws.t / draws.t.abs().max(),
                       0.0, 1.0)


def _zoo_search_pair(label, atks, scenes, draws, out, cpu, dev) -> str:
    """The search's winner, best cost and texture, card against CPU; a
    different winner passes only as a near-tie, with both costs logged."""
    win = {d: int(atks[d].last_best) for d in (cpu, dev)}
    cost = {d: float(atks[d].last_cost) for d in (cpu, dev)}
    note = (f"winner card {win[dev]} CPU {win[cpu]}, best cost card "
            f"{cost[dev]:.8e} CPU {cost[cpu]:.8e}")
    if _rel(cost[dev], cost[cpu]) > ZOO_COST_RTOL:
        raise AssertionError(f"zoo {label}: best costs disagree: {note}")
    if win[dev] == win[cpu]:
        if float((out[dev] - out[cpu]).abs().max()) > 1e-6:
            raise AssertionError(f"zoo {label}: the same winner's textures "
                                 f"disagree")
        return note
    # another winner: each device's cost of the other's texture
    atk = atks[cpu]
    z, a = ((draws.z0s, draws.alphas) if label == "Square" else
            (draws.z0s[win[dev]], draws.alphas[win[dev]]))
    with torch.no_grad():
        other = float(atk._objective(atk._replicate(scenes[cpu], 2),
                                     out[dev], z, a))
    note += f"; near-tie: the card's winner costs {other:.8e} on the CPU"
    if _rel(other, cost[cpu]) > ZOO_COST_RTOL:
        raise AssertionError(f"zoo {label}: another winner, not a near-tie: "
                             f"{note}")
    return note


def _preset_cfg(name, cfg):
    """A preset with 13b's cuts: one batch; Square's queries and light's
    candidates cut to ZOO_SQUARE_QUERIES and ZOO_LIGHT."""
    cfg = dataclasses.replace(cfg, eval_count=1)
    if cfg.norm_type == "Square":
        cfg = dataclasses.replace(cfg, n_queries=ZOO_SQUARE_QUERIES)
    if cfg.norm_type == "light":
        cfg = dataclasses.replace(cfg, n_inits=ZOO_LIGHT[0],
                                  n_neighbors=ZOO_LIGHT[1])
    return cfg


def _timed_optimize(attack) -> dict:
    """Times each `_optimize` call of `attack` (synchronised) into the
    returned dict's "s"."""
    out = {}
    orig = attack._optimize

    def run(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a)
        torch.cuda.synchronize()
        out["s"] = time.perf_counter() - t0
        return r

    attack._optimize = run
    return out


def _queries(cfg) -> int:
    return {"Square": cfg.n_queries + 1,
            "light": 2 * cfg.n_inits * cfg.n_neighbors,
            "guassian": cfg.step}.get(cfg.norm_type, 0)


def phase_zoo_presets(dev, sd) -> dict:
    """13b: the 16 presets at full width (Monodepth2-18, 1024x320,
    float32, eval mode, the golden weights, 375x1242 synthetic scenes, the
    300x200 car), one batch each at the preset's batch size through
    build_attack + evaluate_attacks, the counters reset before each and
    read after: s/batch, the search's ms a query, the 8 mean metrics
    (finite), peak memory, launches against `zoo_launches`. Then the idle
    share of one shorter batch of Square and of light."""
    predictor = _golden_predictor(dev, sd)
    obj, mask = make_car_object(300, 200, seed=SEED)
    total = {k.name: 0 for k in _build.KERNELS}
    log(f"zoo 13b: the 16 presets (evaluation/presets.py) at 1024x320 f32, "
        f"golden weights, one batch of 375x1242 synthetic scenes each, car "
        f"300x200; Square cut to {ZOO_SQUARE_QUERIES} queries, light to "
        f"{ZOO_LIGHT[0]} x {ZOO_LIGHT[1]} x 2 = {2 * ZOO_LIGHT[0] * ZOO_LIGHT[1]}"
        f" candidates:")
    per_query = {}
    for i, (name, preset) in enumerate(EVAL_PRESETS.items()):
        cfg = _preset_cfg(name, preset)
        attack = build_attack(cfg, predictor, obj, mask)
        opt = _timed_optimize(attack) if cfg.norm_type != "image" else {}
        scenes = make_scene(cfg.batch_size, cfg.ori_h, cfg.ori_w,
                            seed=SEED + 130 + i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = evaluate_attacks(predictor, attack, [scenes], cfg,
                               generator=torch.Generator().manual_seed(
                                   SEED + 150 + i))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _build.KERNELS}
        for k, v in launches.items():
            total[k] += v
        want = zoo_launches(cfg, getattr(attack, "last_iterations", 0))
        got = {k: launches[k] for k in want}
        q = _queries(cfg)
        extra = ""
        if q:
            per_query[cfg.norm_type] = (opt["s"] / q * 1e3, secs - opt["s"])
            extra = (f", {opt['s'] / q * 1e3:.3f} ms a query of {q} "
                     f"({opt['s']:.4f} s searching)")
        if cfg.norm_type == "l_0":
            extra = f", {attack.last_iterations} L0 iterations"
        log(f"  {name} ({cfg.norm_type}, batch {cfg.batch_size}): "
            f"{secs:.4f} s/batch{extra}; peak "
            f"{torch.cuda.max_memory_allocated(dev)} B; metrics mean "
            f"{json.dumps({k: round(v, 6) for k, v in res['mean'].items()})};"
            f" launches {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"zoo preset {name}: launches {got}, "
                                 f"predicted {want}")
        if other := {k: v for k, v in launches.items()
                     if k not in want and v}:
            raise AssertionError(f"zoo preset {name}: unexpected {other}")
        vals = list(res["mean"].values()) + list(res["max"].values())
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"zoo preset {name}: non-finite {res}")
    bad = [n for n in ZOO_KERNELS if total[n] <= 0]
    if bad:
        raise AssertionError(f"kernels never launched in the zoo: {bad}")
    # the Gaussian search's blur alone: a depthwise F.conv2d a pass, by
    # im2col with use_f32_numerics (cuDNN off), up to 599 taps
    g_atk = build_attack(EVAL_PRESETS["gaussian"], predictor, obj, mask)
    sig, kernels = g_atk.sigmas(), g_atk._kernels
    all_ms = cuda_ms(lambda: [_blur_hw(g_atk.obj_img, k) for k in kernels],
                     reps=3)
    last_ms = cuda_ms(lambda: _blur_hw(g_atk.obj_img, kernels[-1]), reps=5)
    log(f"  blur: the Gaussian preset's {len(sig)} sigmas on the 300x200 "
        f"car, {all_ms:.3f} ms in all (card alone), sigma {sig[-1]:g} "
        f"(399 and 599 taps) {last_ms:.3f} ms")
    for nt, full in (("Square", 5001), ("light", 8000)):
        ms, rest = per_query[nt]
        log(f"  extrapolated, not measured: {nt} at its preset's length "
            f"({full} evaluations) {ms * full / 1e3 + rest:.1f} s/batch "
            f"({ms:.3f} ms a query x {full} + {rest:.4f} s of finals and "
            f"metrics)")
    for nt, kw in ZOO_PROFILE.items():
        name = "square_eps01" if nt == "Square" else "light"
        cfg = dataclasses.replace(EVAL_PRESETS[name], eval_count=1, **kw)
        attack = build_attack(cfg, predictor, obj, mask)
        scenes = make_scene(cfg.batch_size, cfg.ori_h, cfg.ori_w,
                            seed=SEED + 170)
        busy_ms, wall_ms, n, _, _ = device_busy(lambda: evaluate_attacks(
            predictor, attack, [scenes], cfg,
            generator=torch.Generator().manual_seed(SEED + 171)))
        log(f"  idle: one {nt} batch ({_queries(cfg)} evaluations, batch "
            f"{cfg.batch_size}) under the profiler: device busy "
            f"{busy_ms:.3f} ms of {wall_ms:.3f} ms host wall, idle share "
            f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    return total


def phase_zoo_surface(dev, sd) -> None:
    """13c: evaluate_clean card against CPU; crosscheck_matrix over the
    golden weights and a seeded init; objects_sweep over two cars;
    physical_eval with a perturbed car for the photographed patch;
    attack_steps_sweep at steps (1, 11). The sweeps at full width, L-inf
    PGD at batch 12."""
    cpu = torch.device("cpu")
    frames = make_scene(2, 320, 1024, seed=SEED + 180)
    rs = np.random.RandomState(SEED + 181)
    gts = []
    for _ in range(2):
        gt = rs.uniform(2.0, 70.0, (375, 1242)).astype(np.float32)
        gt[rs.rand(375, 1242) < 0.6] = 0.0
        gts.append(gt)
    preds = {d: _golden_predictor(d, sd) for d in (cpu, dev)}
    for kw in (dict(), dict(post_process=True), dict(eval_stereo=False),
               dict(eval_stereo=False, post_process=True)):
        cfg = clean_eval.CleanEvalConfig(**kw)
        t0 = time.perf_counter()
        got, _ = clean_eval.evaluate_clean(preds[dev], zip(frames, gts), cfg)
        secs = time.perf_counter() - t0
        want, _ = clean_eval.evaluate_clean(preds[cpu], zip(frames, gts), cfg)
        ok = np.allclose(list(got.values()), list(want.values()),
                         rtol=ZOO_METRIC_TOL, atol=ZOO_METRIC_TOL)
        log(f"zoo 13c: evaluate_clean {kw or 'stereo'} on 2 frames: card "
            f"{json.dumps({k: round(v, 6) for k, v in got.items()})} "
            f"({secs:.3f} s), CPU abs_rel {want['abs_rel']:.6f}")
        if not ok:
            raise AssertionError("evaluate_clean: card and CPU disagree")
    cfg = AttackEvalConfig(norm_type="l_inf", epsilon=0.1, alpha=0.005,
                           step=10, batch_size=12, eval_count=1)
    obj, mask = make_car_object(300, 200, seed=SEED)
    scenes = make_scene(12, 375, 1242, seed=SEED + 182)
    seeded = predictor_from(init_monodepth2(
        torch.Generator().manual_seed(SEED + 183)).to(dev))
    results = {
        "crosscheck_matrix": sweeps.crosscheck_matrix(
            {"golden": preds[dev], "seeded": seeded}, obj, mask,
            lambda: [scenes], cfg),
        "objects_sweep": sweeps.objects_sweep(
            preds[dev], {"Sedan": make_car_object(300, 200, seed=SEED),
                         "SUV": make_car_object(300, 200, seed=SEED + 1)},
            lambda: [scenes], cfg),
        "physical_eval": {"patch": sweeps.physical_eval(
            preds[dev], obj, mask, np.clip(obj * 0.7 + 0.2, 0, 1) * mask,
            lambda: [scenes], cfg)},
        "attack_steps_sweep": sweeps.attack_steps_sweep(
            preds[dev], obj, mask, lambda: [scenes], cfg,
            candi_steps=(1, 11)),
    }
    for name, res in results.items():
        flat = {}
        for k, r in res.items():
            if "mean" in r:
                flat[str(k)] = r["mean"]["abs_rel"]
            else:
                flat.update({f"{k}->{t}": v["mean"]["abs_rel"]
                             for t, v in r.items()})
        log(f"zoo 13c: {name}: abs_rel {json.dumps(flat)}")
        if not all(math.isfinite(v) for v in flat.values()):
            raise AssertionError(f"{name}: non-finite metrics")


def phase_zoo_distill(dev, sd) -> None:
    """13d: one warm-up and two timed distillation steps with
    adv_type="image" (float32, batch 32, 1024x320, whole-image PGD-10,
    golden teacher and student): s/step; D and B launches as phase 9's a
    step (48 + 44, 12 + 11), D's weight gradients only the student's (4),
    no kernel A."""
    cfg = DistillConfig(adv_type="image", batch_size=32)
    obj, mask = make_car_object(300, 200, seed=SEED)
    trainer = _distill_trainer(dev, cfg, sd, obj, mask, SEED + 190)
    scenes = torch.from_numpy(make_scene(32, cfg.ori_h, cfg.ori_w,
                                         seed=SEED + 191)).to(dev)
    state = trainer.make_state()
    state, _ = trainer.train_step(state, scenes)
    torch.cuda.synchronize()
    _build.reset_launches()
    losses = []
    with counting_weight_grads() as wgrads:
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = trainer.train_step(state, scenes)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / 2
    launches = {k.name: k.launches // 2 for k in _build.KERNELS if k.launches}
    want = {"maxpool3x3s2_fwd": 12, "maxpool3x3s2_bwd": 11,
            "conv3x3_fwd": D_FWD_PER_STEP, "conv3x3_dgrad": D_DGRAD_PER_STEP}
    log(f"zoo 13d: DistillTrainer.train_step, adv_type image, float32, batch "
        f"32 at 1024x320, PGD-{cfg.steps} eps {cfg.epsilon}, golden teacher "
        f"and student: {secs:.4f} s/step (2 steps after 1 warm-up, host "
        f"clock, synchronised), losses {losses}, launches a step "
        f"{json.dumps(launches)} (predicted {json.dumps(want)}, no A), D "
        f"weight gradients a step {len(wgrads) / 2:g}")
    if launches != want or len(wgrads) != 2 * D_WGRAD_PER_STEP or \
            not all(math.isfinite(v) for v in losses) or state.step != 3:
        raise AssertionError("the image distillation step failed")


def main() -> int:
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{name}: {time.perf_counter() - t0:.1f} s]")
        return out

    dev = timed("phase 1", phase_device)
    timed("phase 2", phase_build)
    log("kernels vs plain versions:")
    rows = timed("phase 3", phase_kernels, dev)
    timed("phase 4", phase_golden, dev)
    launches, attack, predictor, scenes = timed("phase 5", phase_slice, dev)
    timed("phase 6", lambda: (phase_cost(attack, scenes), phase_breakdown(
        attack, predictor, scenes, rows)))
    timed("phase 7", phase_idle, attack, scenes)
    del attack, predictor, scenes
    torch.cuda.empty_cache()
    train_launches = timed("phase 8", phase_train, dev)
    torch.cuda.empty_cache()
    distill_launches = timed("phase 9", phase_distill, dev)
    torch.cuda.empty_cache()
    bench_launches = timed("phase 10", phase_bench, dev)
    torch.cuda.empty_cache()
    harden = timed("phase 11", phase_harden, dev)
    torch.cuda.empty_cache()
    cli = timed("phase 12", phase_cli, dev)
    torch.cuda.empty_cache()
    zoo = timed("phase 13", phase_zoo, dev)
    for name, r in rows.items():
        r["launches"] = (launches[name] + train_launches[name]
                         + distill_launches[name] + bench_launches[name]
                         + harden[name] + cli[name] + zoo[name])
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "host_ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
