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
   375x1242 scenes) through build_attack + evaluate_attacks, after its
   first batch twice from a generator seeded alike (phase 18's pair, the
   warm-up), with every launch counter reset before and read after; then
   a check that 10 steps lower the targeted cost below its value at the
   random start.
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
   then 2 warm-up steps, each from a fresh state (phase 18's pair), and
   3 timed steps, with every launch counter reset before the timed
   steps and read after; checks that the loss is finite, the weights and BatchNorm
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
   on the CPU's plain versions; then 2 warm-up steps from a fresh state
   (phase 18's pair) and 3 timed steps with every launch counter reset
   before the timed steps and read after
   (kernel D must launch 48 times forward and 44 times backward per
   step, and compute weight gradients for the student only); checks
   that the loss is finite, the weights and BatchNorm statistics moved
   and the unused disparity heads did not; that Adam steps on one fixed
   adversarial batch lower the MSE; one step with the cropped objective
   (320x256) launches D at the crop's shape; then the breakdown of a
   step, its device ms by kernel, its idle share and its reflection
   pads (the forward kernel's ms and launches, the backward passes of
   the port's fixed-order adjoint, as predicted: every decoder conv
   pads; F.pad's own atomic backward never runs).
10. bench: the distillation step in bench.py's configuration
   (bench.py:81-115): DistillConfig with compute_dtype bfloat16, the
   320x256 cropped objective, the bf16 attack view and fold_bn, PGD-10,
   batch 32 at 1024x320, a bf16 folded disp0 teacher from the golden
   weights (BatchNorm statistics calibrated on synthetic scenes), a
   student from a seeded init, one 375x1242 scene replicated and the
   300x200 car: first one small step on the card against the CPU's
   plain versions (bf16 both); then 2 warm-up steps from a fresh state
   (phase 18's pair) and 3 timed steps with every launch counter reset
   before the timed steps and read after
   (kernel D's and B's bf16 instances must launch 48 + 44 and 12 + 11
   times per step, their float32 ones never; B-bf16 10 + 10 times on the
   crop's stem and 2 + 1 at full frame): seconds per step, peak
   memory, the idle share and device ms by kernel of one step, its
   reflection pads (as phase 9's: D's bf16 convs pad nothing but the
   student's weight-gradient inputs); then one untimed step with
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
   steps from a fresh state (phase 18's pair) and 3 timed steps with
   every launch counter reset before the timed
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
   included; then for each of 12a and 12b 2 warm-up steps from a fresh
   state (phase 18's pair) and 2 timed steps
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
   `zoo_launches`; the image_eps001 and l0_thresh01 batches once more
   (phase 18's pairs); Square and light extrapolated to their presets'
   lengths; the idle share of a shorter Square and light batch. 13c:
   evaluate_clean card against CPU (stereo or median scaling, with and
   without the flip post-process), crosscheck_matrix over the golden
   weights and a seeded init, objects_sweep over two cars, physical_eval
   with a perturbed car for the photographed patch, attack_steps_sweep
   at steps (1, 11). 13d: the distillation step with adv_type "image"
   (float32, batch 32, PGD-10, golden teacher and student): s/step, D
   and B launches as phase 9's, D's weight gradients the student's only,
   no kernel A.
14. families: BASELINE config 5's model families as the CLI's bf16
   `train-hardening --fine-tune` runs them at 1024x320, batch 32, L0
   10 steps on attack batch 12, student and float32 teacher of the
   family from one seeded init with BatchNorm statistics calibrated on
   synthetic scenes (the bf16 eval disp0's distance from float32
   logged): 14a DepthHints on ResNet-50 (contras_loss_wt 0.1; the hints
   from `fuse_depths` on the card over 12 candidate shifts, checked
   first on a model-size scene: the true shift on every textured pixel,
   the argmin ties counted), 14b ManyDepth (zero lookups), 14c ManyDepth
   with the real lookup (frames 0,-1,1,s, the 96-bin sweep). Each: a
   small float32 step under phase 11's rule and a small bf16 supervised
   step under phase 12's, the decoder's gradients also held on their own
   to those overall bounds (on ResNet-50 the whole model's overall
   bounds are FAMILY_GRAD_L2_ALL's: fixed, 1.5 times the rounding its
   step amplifies from one ulp); then 2 warm-up steps from a fresh state
   (phase 18's pair) and 3 timed steps with
   launches against `harden_launches`, finite loss terms, everything but
   the never-applied prematching conv moved, one profiled step. 14d:
   `load_manydepth_reference` from a weights folder written from 14b's
   weights, then `ManyDepthModel` at 640x192, batch 12, single-frame and
   `multi_frame`: card against CPU on 2 items (disp0 within 1e-4,
   lowest_cost and confidence), 2 + 5 forwards with launches (B 1, D 4
   a forward), one profiled forward.
15. cli: the port's command line, `cli.main.main([...])` on the card, on
   KITTI-layout trees the phase writes under a temporary directory at
   375x1242 (tests/kitti_trees.py: standard-library PNGs, the calib
   files, velodyne scans; a raw drive of 32 frames x 2 eyes, an object
   tree of 24 scenes, the 300x200 car, a weights folder of phase 12's
   calibrated golden weights): `native.decoder()`'s route; fetch-splits
   (--from-dir, --generate-odom); export-gt-depths; eval-clean on 8 test
   lines (launches: B 1 and D 4 a frame); eval-attacks with an L0 and an
   L-inf preset, --eval-count 2 (launches against `zoo_launches` of each
   batch); train-hardening --fine-tune at its defaults (bf16 student,
   float32 teacher, L0 10 steps on attack batch 12, batch 32, frames
   0,s, a robustness val at step 0) with --epochs 1 --log-frequency 1,
   run twice (the second resumes at step 2): seconds a step (host clock
   around `train_step`, synchronised), each batch's wait on the prefetch
   loader, each step's launches against `harden_launches(i, bf16=True)`,
   one step under the profiler (idle share), peak memory, the JSONL keys,
   checkpoints and opt.json, and the first step against two direct
   `train_step`s of trainers built from the same seed on the same loader
   batch and scenes, bit for bit (the two direct steps are phase 18's
   pair for 15a); train-distill --epochs 1
   --eval-count 1 on a list of two batches (JSONL, weights folders, the
   kernels it runs launched); infer where PIL imports (B 1, D 4);
   precompute-hints where cv2 and PIL import (two frames' SGBM hints
   fused on the card at 1024x320: the files, their shape, finite, C once
   a hint); eval-attacks --dump-dir where PIL and matplotlib import
   (otherwise a line says which is missing); each subcommand's wall
   seconds.
16. parallel: data parallelism, inside phase 15's temporary directory.
   16a: the CLI's step (12a's configuration) at global batch 32 on two
   ranks of the one card over gloo (NCCL refuses two ranks on one card),
   each a child process (`dp_rank`) joined with a timeout, its group
   through a file store with a 60 s timeout, against one process on the
   same inputs and injected draws: the ranks' textures bit-equal, their
   L0 iterations the one process's, the share of texels where they
   differ from the one process's texture (a reading); the training half
   on the one process's texture with the float32 student within
   DP_SPREAD_X times the larger of one process's two-run spread and
   its one-ulp spread (loss and running statistics with DP_LOSS_RTOL and
   DP_STATS_FLOOR), while each of DP_FAULTS planted on the ranks (the
   gradient mean skipped, BatchNorm over a rank's rows) must fail that
   rule; the bf16 half's gradients a reading, its loss and statistics
   held alike; each rank's launches `harden_launches(i, bf16=True)`;
   each rank's s/step and the gradients' all-reduce. 16b:
   `train-hardening --fine-tune --data-parallel` on phase 15's tree over
   NCCL at world size 1, 2 steps: launches, the first step against phase
   15's (bf16: the gradients a reading, the loss and statistics held),
   rank 0's checkpoint, s/step, the all-reduce alone; 16a's float32 half
   over the same group, held by 16a's rule. 16c: the
   JAX package's tests/test_convergence.py with the port at its shapes
   and with its assertions (40 distillation steps, 50 hardening steps on
   `make_stereo_pair`). 16d: `models/zoo.load_pretrained` from a zip
   written here onto the card against the CPU (no fetch: urllib's
   `urlretrieve` raises).
17. classifier: the classifier attack surface (attacks/classifier.py,
   classifier_auto.py) through a ResNet-18 classifier (the port's
   ResnetEncoder(18), a global average pool, Linear(512, 10); flax's
   seeded init with BatchNorm statistics calibrated on the batch, eval,
   float32, `CountingClassifier`), 224x224, batch 16 of synthetic
   scenes, the labels its own predictions. 17a: every attack of both
   modules once at JAX's defaults but CLS_CUTS (DeepFool's, SparseFool's
   and FAB's iterations, OnePixel's generations and population, Square's
   queries, APGD's and APGD-T's steps and AutoAttack's inner budgets),
   PGD twice (phase 18's pair): seconds, the
   constraint (L-inf, L2 or L0 against eps), accuracy before and after,
   the goal class's mean probability, the model's forwards and input
   gradients against the predicted ones; fails on a broken constraint,
   a non-finite output, an untargeted attack that raises accuracy, a
   targeted one that lowers its target's probability. 17b: FGSM, BIM (3
   steps), PGD from an injected start, MIFGSM, CW (3 steps), DeepFool (2
   steps) and APGD (5 steps, injected start) on the card against the
   CPU at batch 2: the input gradient at the images and at PGD's start
   within CLS_GRAD_L2 relative L2, FGSM's step split on at most CLS_SPLIT_ONE of
   the values, DeepFool within CLS_SAME_DF, the others' adversarial
   images predicted alike (their first splits spread through the
   receptive field: the share apart is logged). 17c: B1's and B2's launches over 17a-17b equal to the
   classifier's forwards and input gradients; B at (16, 64, 112, 112)
   bit for bit against its plain version, timed beside it, the library
   and the bound. 17d: the options the earlier slices left: ManyDepth's
   evaluation (14d's setting, seeded weights) from a folder whose
   metadata says `depth_binning: "inverse"`, and with missing bins left
   at 0, card against CPU by 14d's rule; the object APGD under L2 (eps 8,
   n_restarts 2) and untargeted whole-image PGD, one batch each of
   their presets at full width, launches against `zoo_launches`; one
   14a step with use_depth_hints False, and the DepthHints loss with
   use_depth_hints=False on the card against the CPU (C launched).
18. repeat: the port gives the same bits twice. Each path of
   REPEAT_PATHS (phase 5's attack batch; one step of phases 8, 9, 10,
   11, 12a, 12b, 14a, 14b and 14c; one batch of the image and l0
   presets; the CLI's first train-hardening step from files; 17a's PGD)
   ran twice where its phase drives it, from the same weights and inputs
   and freshly seeded generators; the two runs' losses, metrics,
   gradients of every tensor, updated parameters, BatchNorm statistics,
   textures, adversarial images and L0 iteration counts must be
   bit-equal. The reflect pad's and the bilinear resize's backward sum
   in a fixed order for it (ops/padding.py, ops/resize.py), where
   PyTorch's own CUDA backward adds with atomics.

Each path's kernels must launch during its own run (counters set to 0
just before it, read just after). Prints one JSON line of kernel
results, then, as the last line, {"ok": true, "device": {...}}. Needs no
network and no jax.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from depthmodelhardening_tpu_torch.attacks import (
    classifier as classifier_attacks, classifier_auto,
)
from depthmodelhardening_tpu_torch.attacks.apgd_object import APGDObjectAttack
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.attacks.pgd_image import PGDImageAttack
from depthmodelhardening_tpu_torch.attacks.l0_object import L0ObjectAttack
from depthmodelhardening_tpu_torch.data import depth_hints as hint_data
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
from depthmodelhardening_tpu_torch.models.resnet import ResnetEncoder
from depthmodelhardening_tpu_torch.models.wrappers import (
    MONODEPTH2_K, ManyDepthModel, flax_init_, init_monodepth2,
    make_monodepth2, predictor_from, quarter_intrinsics,
)
from depthmodelhardening_tpu_torch.ops import (
    _build, conv, conv_route, padding, pool, reproj, warp,
)
from depthmodelhardening_tpu_torch.parallel.mesh import Mesh
from depthmodelhardening_tpu_torch.ops.padding import reflect_pad1
from depthmodelhardening_tpu_torch.ops.resize import bilinear_resize
from depthmodelhardening_tpu_torch.physics.eot import (
    ANGLE_RANGE, TRAIN_DIST_RANGE, stereo_T,
)
from depthmodelhardening_tpu_torch.training import checkpoints
from depthmodelhardening_tpu_torch.training.adv_synth import (
    make_synth_compositor, stereo_T_batch, synth_tile,
)
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, DistillConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.distill import DistillTrainer
from depthmodelhardening_tpu_torch.training.hardening import (
    HardeningTrainer, make_family_model,
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

    # the first batch twice, untimed (allocator warm-up): phase 18's pair
    first = torch.from_numpy(batches[0]).to(dev)
    repeat_twice("5", lambda: eval_run(predictor, attack, first, CFG, SEED))
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
    clock around the call. The trace's device activities are read as
    kineto recorded them, without the profiler's tree of host events
    (building it took minutes a phase on a slow host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.name().startswith(("Buffer Flush",
                                           "Activity Buffer"))]
    if not events:
        raise AssertionError("the profiler saw no device activity")
    by_name, counts = {}, {}
    for name, _, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
        counts[name] = counts.get(name, 0) + 1
    spans = sorted((start, start + dur) for _, start, dur in events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e3, wall_ms, len(spans), by_name, counts


def reflect_pads(by_name, counts):
    """(forward ms, launches, backward ms, launches) of the reflection-pad
    kernels (F.pad's reflect mode and its atomic backward, which the port
    no longer runs) in a profile."""
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
TRAIN_TIMED, CONVERGE_STEPS, CONVERGE_LR = 3, 6, 1e-4


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
    start = {k: v.clone() for k, v in
             trainer.make_state().model.state_dict().items()}
    losses = []

    def step():
        _reseed(trainer, SEED + 21)
        state, m = trainer.selfsup_frames_step(trainer.make_state(), frames,
                                               side, flip)
        losses.append(m["loss"])
        return outcome(_state_modules(state), m), state

    # the warm-up: two steps from a fresh state, phase 18's pair
    state = repeat_twice("8", step)
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
        f"steps after 2 warm-up from a fresh state, synchronised)")
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
    if state.step != 1 + TRAIN_TIMED:
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
DISTILL_TIMED, DISTILL_FIT_STEPS = 3, 6
# kernel D per step: the 4 convs of the scale-0 path forward in the 10
# attack passes, the teacher's and the student's; their input gradients
# in the attack's passes and the student's; weight gradients only in the
# student's backward (the attack runs on detached weights)
D_FWD_PER_STEP = 4 * (DISTILL_CFG.steps + 2)
D_DGRAD_PER_STEP = 4 * (DISTILL_CFG.steps + 1)
D_WGRAD_PER_STEP = 4
# reflection pads per step (F.pad's reflect kernel, the port's adjoint):
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


def distill_run(trainer, scenes, seed, losses):
    """One distillation `train_step` from a fresh state, the trainer's
    generator seeded with `seed`, its loss appended to `losses`: (its
    outcome with the attack's texture, the state)."""
    _reseed(trainer, seed)
    with _keeping(trainer.attack, "_optimize", []) as tex:
        state, m = trainer.train_step(trainer.make_state(), scenes)
    losses.append(m["loss"])
    return outcome(_state_modules(state), m, texture=tex[0]), state


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
    start = {k: v.clone() for k, v in
             trainer.make_state().model.state_dict().items()}
    losses = []
    # the warm-up: two steps from a fresh state, phase 18's pair
    state = repeat_twice("9", lambda: distill_run(trainer, scenes, SEED + 41,
                                                  losses))
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
        f"steps after 2 warm-up from a fresh state, synchronised)")
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
    with counting_pad_adjoints() as adjoints:
        busy_ms, wall_ms, n, by_name, counts = device_busy(
            lambda: trainer.train_step(state, scenes))
    d_ms = sum(ms for k, ms in by_name.items() if "conv3x3_" in k)
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    log(f"  kernel D: {d_ms:.3f} device ms of the step, "
        f"{d_ms / busy_ms:.4f} of its busy time")
    check_reflect_pads("distill", by_name, counts, adjoints, DISTILL_PADS)
    log("  device ms of the step by kernel (top 12):")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:9.3f}  {k[:110]}")


@contextlib.contextmanager
def counting_pad_adjoints():
    """Counts the reflect pad's backward passes (`padding.
    reflect_pad1_adjoint`, its fixed-order adjoint) while active."""
    calls = []
    orig = padding.reflect_pad1_adjoint
    padding.reflect_pad1_adjoint = lambda g: calls.append(1) or orig(g)
    try:
        yield calls
    finally:
        padding.reflect_pad1_adjoint = orig


def check_reflect_pads(label, by_name, counts, adjoints,
                       predicted) -> None:
    """Logs a profiled step's reflection pads: the forward kernel's ms
    and launches, the backward passes (`adjoints`: the calls of the
    port's adjoint); they must be `predicted` (forward, backward), and
    F.pad's own atomic backward must not launch."""
    f_ms, f_n, b_ms, b_n = reflect_pads(by_name, counts)
    log(f"  reflection pad: forward {f_ms:.3f} device ms in {f_n} "
        f"launches, backward {len(adjoints)} passes of the fixed-order "
        f"adjoint (predicted {predicted[0]} + {predicted[1]}); F.pad's own "
        f"backward {b_n} launches ({b_ms:.3f} ms)")
    if (f_n, len(adjoints)) != predicted or b_n:
        raise AssertionError(f"{label}: reflection pads ran {f_n} + "
                             f"{len(adjoints)} times, predicted {predicted}"
                             f", F.pad's backward {b_n} times")


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
BENCH_TIMED = 3
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
# CPU, tests/test_torch_bf16_steps.py); a wrong kernel is off by about 1. On an
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
    losses = []
    # the warm-up: two steps from a fresh state, phase 18's pair
    state = repeat_twice("10", lambda: distill_run(trainer, scenes,
                                                   SEED + 62, losses))
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
        f"steps after 2 warm-up from a fresh state, synchronised)")
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
    with counting_pad_adjoints() as adjoints:
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
    check_reflect_pads("bench", by_name, counts, adjoints, BENCH_PADS)
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
HARDEN_TIMED = 3
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
                    bf16: bool = False, hints: bool = False) -> dict:
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
    teacher's 4 convs forward. With DepthHints (`hints`) C runs once more
    forward: the hint's reprojection loss, whose inputs need no gradient.
    The Bottleneck ResNets' decoder routes the same convs to D, and the
    ManyDepth student's stem pools once a pass (the real lookup's stem
    takes the lookups in the same launch)."""
    i, t = iterations, temporal
    sfx = "_bf16" if bf16 else ""
    out = {k.name: 0 for k in _build.KERNELS}
    out.update({"vertical_resample_fwd": i + 2, "vertical_resample_bwd": i,
                "maxpool3x3s2_fwd": 1 + t, "maxpool3x3s2_bwd": t,
                "reproj_loss_fwd": 5 * (1 + t) + int(hints),
                "reproj_loss_bwd_q": 4 * (1 + t),
                "reproj_loss_bwd_grad": 4 * (1 + t), "conv3x3_fwd": 4})
    for name, n in (("maxpool3x3s2_fwd", i + 2), ("maxpool3x3s2_bwd", i + 2),
                    ("conv3x3_fwd", 4 * i + 6), ("conv3x3_dgrad", 4 * i + 6)):
        out[name + sfx] += n
    return out


def run_hardening_steps(label, trainer, inputs, timed, repeat=True):
    """`timed` `train_step`s of `trainer` on `inputs` (frames, sides,
    flips, scene), after, with `repeat`, a warm-up of two steps from a
    fresh state (`hardening_run`: phase 18's pair, recorded under
    `label`), with every launch counter reset before the timed ones and
    read after: logs seconds per step, peak memory, each step's L0
    iterations and early break, the loss terms and the launches beside
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

    def seen(m):
        metrics.append(m)
        iters.append((trainer.attack.last_iterations,
                      trainer.attack.last_early_break))

    warmup = 2 if repeat else 0
    if repeat:
        state = repeat_twice(label, lambda: hardening_run(
            trainer, inputs, SEED + 80, seen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = trainer.train_step(state, frames, side, flip, scene)
        seen(m)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / timed
    launches = {k.name: k.launches for k in _build.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    predicted = {k.name: 0 for k in _build.KERNELS}
    for n_it, _ in iters[warmup:]:
        for k, v in harden_launches(
                n_it, len(cfg.selfsup.temporal_source_ids),
                cfg.compute_dtype == "bfloat16",
                cfg.use_depth_hints).items():
            predicted[k] += v
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    log(f"  seconds per step {secs:.4f} (host clock around {timed} steps "
        f"after {warmup} warm-up from a fresh state, synchronised)")
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
    params = [n for n, _ in _named_params(state)
              if not n.startswith(NEVER_APPLIED)]
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]
    still = (set(params) | set(stats)) - moved
    if still or state.step != min(warmup, 1) + timed:
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


def _harden_trainer(dev, cfg, sd, obj, mask, seed, mesh=None):
    """Student and frozen float32 teacher of cfg's family from the
    weights `sd` (--fine-tune); the SimSiam head from `seed`."""
    teacher = make_family_model(cfg)
    teacher.load_state_dict(sd)
    return HardeningTrainer(cfg, torch.Generator().manual_seed(seed), obj,
                            mask, predictor_from(teacher.to(dev)),
                            device=dev, init_state_dict=sd, mesh=mesh)


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
    if cfg.use_depth_hints:
        # the depth of the 12-column shift at model resolution, invalid on
        # a seeded fifth of the pixels (the full-size run fuses its own)
        ss = cfg.selfsup
        depth = 0.58 * ss.width * 0.1 / (12 * ss.width / cfg.adv.ori_w)
        valid = (torch.rand(B, ss.height, ss.width, 1, generator=torch
                            .Generator().manual_seed(seed + 2)) > 0.2).float()
        frames["depth_hint"] = (depth * valid).to(dev)
        frames["depth_hint_mask"] = valid.to(dev)
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
        "11", trainer, (frames, side, flip, scene), HARDEN_TIMED)
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


def phase_harden_parity(dev, frame_ids=("0", "s"), family=None,
                        sd=None, grad_l2_all=HARDEN_GRAD_L2_ALL) -> None:
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
    away: the scale of the rounding the step amplifies. `family`:
    HardeningConfig fields of a model family (phase 14), whose student
    and teacher start from `sd` (default the golden weights), its
    gradients held overall within `grad_l2_all` (FAMILY_GRAD_L2_ALL) and
    its decoder's within HARDEN_GRAD_L2_ALL."""
    ss = dataclasses.replace(HARDEN_CFG.selfsup, height=64, width=192,
                             frame_ids=frame_ids)
    adv = dataclasses.replace(HARDEN_CFG.adv, steps=2, attack_batch_size=2,
                              ori_h=96, ori_w=320)
    cfg = dataclasses.replace(HARDEN_CFG, selfsup=ss, adv=adv, batch_size=4,
                              learning_rate=CONVERGE_LR, **(family or {}))
    if sd is None:
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
        trainers[0].identity_noise_shape(cfg.batch_size),
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
    grads = lambda st: {n: p.grad for n, p in _named_params(st)
                        if p.grad is not None}
    g_cpu, g_gpu = grads(s_cpu), grads(s_gpu)
    if set(g_cpu) != set(g_gpu):
        raise AssertionError("the card and the CPU differ in which "
                             "parameters got a gradient")
    gw, gw_name, ga = _l2_with_floor(g_gpu, g_cpu, HARDEN_GRAD_FLOOR)
    uw, uw_name, ua = _l2_with_floor(grads(s_ulp), g_cpu, HARDEN_GRAD_FLOOR)
    worst = max(float((p.detach().cpu() - q.detach()).abs().max())
                for (_, p), (_, q) in zip(_named_params(s_gpu),
                                          _named_params(s_cpu)))
    lr = cfg.learning_rate
    log(f"harden parity: one step at 64x192 batch 4, frames {frame_ids}, "
        f"{_family_name(cfg)}, "
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
              "gradient, overall": (ga, grad_l2_all),
              "parameters": (worst, 2.5 * lr)}
    if family:
        dec = lambda g: {n: v for n, v in g.items() if n.startswith(DECODER)}
        da = _l2_with_floor(dec(g_gpu), dec(g_cpu), HARDEN_GRAD_FLOOR)[2]
        ud = _l2_with_floor(dec(grads(s_ulp)), dec(g_cpu),
                            HARDEN_GRAD_FLOOR)[2]
        limits["decoder's gradient, overall"] = (da, HARDEN_GRAD_L2_ALL)
        log(f"  held (phase 14): gradients worst tensor {HARDEN_GRAD_L2}, "
            f"overall {grad_l2_all:.3e}; the decoder's overall {da:.3e} "
            f"(one ulp away {ud:.3e}) within {HARDEN_GRAD_L2_ALL}")
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
CLI_TIMED = 2
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


def phase_cli_run(label, trainer, inputs, timed=CLI_TIMED,
                  weights="the golden weights"):
    """Phase 18's pair as the warm-up and `timed` steps
    (`run_hardening_steps`), then one profiled step: idle share and
    device ms by kernel instance. Returns (state, launches)."""
    cfg = trainer.cfg
    log(f"cli {label}: HardeningTrainer.train_step at the CLI's "
        f"train-hardening --fine-tune defaults: {_family_name(cfg)}, "
        f"student in {cfg.compute_dtype} and float32 teacher from "
        f"{weights} (statistics calibrated), "
        f"{cfg.selfsup.width}x{cfg.selfsup.height}, frames "
        f"{cfg.selfsup.frame_ids}, L0 steps {cfg.adv.steps} on attack batch "
        f"{cfg.adv.attack_batch_size}, supervised + contrastive + "
        f"photometric, batch {cfg.batch_size} of {cfg.adv.ori_w}x"
        f"{cfg.adv.ori_h} frames, car 300x200, Adam lr {cfg.learning_rate}")
    state, launches = run_hardening_steps(label, trainer, inputs, timed)
    busy_ms, wall_ms, n, by_name, counts = device_busy(
        lambda: trainer.train_step(state, *inputs))
    log(f"  idle: one step under the profiler: device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities, "
        f"{trainer.attack.last_iterations} L0 iterations")
    log_kernel_ms(by_name, counts)
    return state, launches


def phase_cli_bf16_parity(dev, teacher_sd, family=None,
                          readings=("supervised", "+ photometric",
                                    "+ contrastive"),
                          frame_ids=("0", "s"),
                          grad_l2_all=BENCH_GRAD_L2_ALL) -> None:
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
    rounding each step amplifies). `family`: HardeningConfig fields of a
    model family (phase 14; `teacher_sd` that family's weights), its
    supervised gradients held overall within `grad_l2_all`
    (FAMILY_GRAD_L2_ALL) and its decoder's within BENCH_GRAD_L2_ALL;
    `readings` the ones to take, `frame_ids` the frames."""
    ss = dataclasses.replace(CLI_CFG.selfsup, height=64, width=192,
                             frame_ids=frame_ids)
    adv = dataclasses.replace(CLI_CFG.adv, steps=2, attack_batch_size=2,
                              ori_h=96, ori_w=320)
    cfg = dataclasses.replace(CLI_CFG, selfsup=ss, adv=adv, batch_size=4,
                              learning_rate=CONVERGE_LR, **(family or {}))
    obj, mask = make_car_object(36, 24, seed=SEED)
    cpu = torch.device("cpu")
    frames, side, flip, scene = _harden_inputs(cpu, cfg, SEED + 92)

    def trainer_on(d, c):
        teacher = make_family_model(c)
        teacher.load_state_dict(teacher_sd)
        return HardeningTrainer(c, torch.Generator().manual_seed(
            CLI_PARITY_SEED), obj, mask, predictor_from(teacher.to(d)),
            device=d)

    trainers = [trainer_on(d, cfg) for d in (cpu, dev)]
    draws = trainers[0].draw(cfg.batch_size,
                             torch.Generator().manual_seed(SEED + 94))
    draws.identity_noise = torch.randn(
        trainers[0].identity_noise_shape(cfg.batch_size),
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

    taken = {}
    for name, kw in (("supervised", dict(no_original_train=True,
                                         contrastive_learning=False)),
                     ("+ photometric", dict(contrastive_learning=False)),
                     ("+ contrastive", {})):
        if name not in readings:
            continue
        c = dataclasses.replace(cfg, **kw)
        (l_cpu, g_cpu), (l_gpu, g_gpu) = (
            grads(trainer_on(d, c)) for d in (cpu, dev))
        if set(g_cpu) != set(g_gpu):
            raise AssertionError("the card and the CPU differ in which "
                                 "parameters got a gradient")
        _, g_ulp = grads(trainer_on(cpu, c), nudge=True)
        dec = lambda g: {n: v for n, v in g.items() if n.startswith(DECODER)}
        taken[name] = (abs(l_gpu - l_cpu) / abs(l_cpu), l_gpu,
                       _l2_with_floor(g_gpu, g_cpu, 0.0)[2],
                       _l2_with_floor(g_ulp, g_cpu, 0.0)[2],
                       _l2_with_floor(dec(g_gpu), dec(g_cpu), 0.0)[2],
                       _l2_with_floor(dec(g_ulp), dec(g_cpu), 0.0)[2])
    log(f"cli bf16 parity: one bf16 step at 64x192 batch 4, frames "
        f"{ss.frame_ids}, {_family_name(cfg)}, L0 steps 2 on attack batch "
        f"2, seeded student, "
        f"float32 teacher: iterations card {iters[1]} CPU {iters[0]}, "
        f"textures split {split:.4%} (logged); on the CPU's batch, card "
        f"against CPU: loss rel, gradient rel L2 overall; the CPU against "
        f"itself with every weight one ulp away:")
    for name, (rel, loss, g_all, ulp, _, _) in taken.items():
        log(f"  {name}: loss {loss:.8e} rel {rel:.3e}, gradients {g_all:.3e};"
            f" one ulp away {ulp:.3e}")
    rel, loss, g_all, ulp, g_dec, ulp_dec = taken["supervised"]
    log(f"  held: supervised, loss rel max {BENCH_LOSS_RTOL}, gradients max "
        f"{grad_l2_all:.3e}" + (
            f"; the decoder's {g_dec:.3e} (one ulp away {ulp_dec:.3e}) max "
            f"{BENCH_GRAD_L2_ALL} (phase 14)" if family else ""))
    if rel > BENCH_LOSS_RTOL or not g_all <= grad_l2_all or \
            not math.isfinite(loss) or (family and
                                        not g_dec <= BENCH_GRAD_L2_ALL):
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
ZOO_SQUARE_QUERIES = 200
ZOO_LIGHT = (10, 10)  # n_inits x n_neighbors x 2 = 200 candidates
ZOO_PROFILE = dict(Square=dict(n_queries=50),
                   light=dict(n_inits=5, n_neighbors=10))
ZOO_KERNELS = SLICE1_KERNELS
# the presets whose batch runs twice (phase 18's paths)
ZOO_REPEAT = {"image_eps001": "13b image", "l0_thresh01": "13b l0"}


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
        first, res = eval_run(predictor, attack, scenes, cfg, SEED + 150 + i)
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
        if name in ZOO_REPEAT:  # phase 18's pair: the same batch again
            record_repeat(ZOO_REPEAT[name], first, eval_run(
                predictor, attack, scenes, cfg, SEED + 150 + i)[0])
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


# -- phase 14 ----------------------------------------------------------------
# BASELINE config 5's model families through the CLI's `train-hardening
# --fine-tune` defaults (phase 12's CLI_CFG: bf16 student, float32 teacher
# of the student's family, L0 10 steps on attack batch 12, batch 32,
# 1024x320, lr 1e-5): 14a `--use-depth-hints --num-layers 50`
# (contras_loss_wt 0.1, as the JAX config's caller sets it), 14b
# `--model-family manydepth` (zero lookups), 14c
# `--manydepth-real-lookup --frame-ids 0,-1,1,s` (the 96-bin sweep); 14d
# the ManyDepth evaluation wrapper from a reference weights folder
FAMILY_RUNS = (
    ("14a", dict(num_layers=50, use_depth_hints=True, contras_loss_wt=0.1),
     ("0", "s")),
    ("14b", dict(model_family="manydepth"), ("0", "s")),
    ("14c", dict(model_family="manydepth", manydepth_real_lookup=True),
     MONO_FRAMES),
)
FAMILY_TIMED = 3
EVAL_WARMUP, EVAL_TIMED = 2, 5  # 14d's forwards
# the small steps' gradients on the card against the CPU: phases 11 and
# 12's rules (float32 worst tensor HARDEN_GRAD_L2, overall
# HARDEN_GRAD_L2_ALL; bf16 supervised overall BENCH_GRAD_L2_ALL), and the
# decoder's gradients, where kernels D and D-bf16 act, held overall to
# those bounds on their own. One departure: on ResNet-50 (14a) the whole
# model's overall bounds are FAMILY_GRAD_L2_ALL's, fixed at 1.5 times the
# CPU's own step with every weight one ulp away (float32 2.367e-2, bf16
# supervised 2.235e-1 as phase 14 read them on the host of an NVIDIA H100
# 80GB HBM3 at 700 W, whose card read 1.741e-2 and 2.127e-1): the
# Bottleneck encoder's and the SimSiam head's gradients move by that much
# from one ulp, its decoder's by 1.082e-3 and 8.145e-3 (phase 14's own
# one-ulp readings there)
FAMILY_GRAD_L2_ALL = {"14a": (3.55e-2, 0.335)}
DECODER = "model.decoder."
# the matching encoder's conv that the reference declares and never applies
NEVER_APPLIED = ("model.encoder.prematching_conv.",)
# 14a's fused hints: 12 candidate depths of these column shifts (pixels at
# model resolution; the "s" frame is "0" shifted by 12 native columns,
# 9.9 at 1024); the fusion's own check places a model-size scene's right
# eye at HINT_TRUE_SHIFT; a pixel's best two losses within HINT_TIE
# (relative) are a tie
HINT_SHIFTS = tuple(range(4, 16))
HINT_TRUE_SHIFT = 10
HINT_TIE = 1e-5
# 14d: ManyDepthModel at 640x192 (the reference's ManyDepth size), batch 12,
# a lookup frame 4 columns over and a 0.1 x-translation; the card against
# the CPU on 2 items: disparities within EVAL_DISP_ATOL, confidence and
# lowest_cost equal but at most EVAL_SPLIT_MAX of the pixels (argmin ties
# of the 96-bin volume, logged)
MANYDEPTH_EVAL = dict(batch=12, height=192, width=640, min_depth_bin=0.1,
                      max_depth_bin=20.0)
EVAL_DISP_ATOL, EVAL_SPLIT_MAX = 1e-4, 1e-3


def _family_name(cfg) -> str:
    if cfg.model_family == "manydepth":
        return (f"ManyDepth on ResNet-{cfg.num_layers} "
                f"({cfg.manydepth_num_depth_bins} bins, "
                + ("a real lookup frame)" if cfg.manydepth_real_lookup
                   else "zero lookups)"))
    return (f"Monodepth2 on ResNet-{cfg.num_layers}"
            + (" with DepthHints" if cfg.use_depth_hints else ""))


def calibrated_family(dev, cfg, seed):
    """A float32 model of cfg's family from flax's initialisation drawn
    from `seed`, every BatchNorm's running statistics set to its batch
    statistics on 4 synthetic scenes at cfg's size (`calibrated_teacher`'s
    rule). Returns (its state dict on the host, the deepest feature's
    largest magnitude and the bf16 eval disp0's relative L2 to the
    float32 one, on 2 other scenes)."""
    ss = cfg.selfsup
    model = flax_init_(make_family_model(cfg), torch.Generator().manual_seed(
        seed)).to(dev).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # a cumulative average: this one batch
    scenes = lambda n, s: bilinear_resize(torch.from_numpy(make_scene(
        n, 375, 1242, seed=s)).to(dev), ss.height, ss.width)
    with torch.no_grad():
        model.features_and_disps(scenes(4, seed + 1))
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    bf16 = make_family_model(cfg, torch.bfloat16)
    bf16.load_state_dict(sd)
    bf16 = bf16.to(dev).eval()
    x = scenes(2, seed + 2)
    with torch.no_grad():
        top = float(model.eval().encode(x)[-1].abs().max())
        d32, d16 = model(x), bf16(x)
    return sd, top, float((d16 - d32).norm() / d32.norm())


def phase_family_hints(dev, cfg, inputs):
    """14a's hints, from `fuse_depths` on the card. First its check: a
    model-size synthetic scene and its right eye HINT_TRUE_SHIFT columns
    over, 12 candidate depths of the shifts HINT_SHIFTS: the fused hint
    must be the true shift's depth on every textured pixel (a horizontal
    step above 0.02 in its 3x3 window, 16 columns in from the borders);
    the argmin ties are counted. Then each item's hint of the batch's
    pair as the batch sees it (resized, flipped where the item is, its
    stereo_T), its mask the hint's validity. Returns the inputs with the
    hint planes."""
    ss = cfg.selfsup
    H, W = ss.height, ss.width
    K, _ = hint_data.scaled_K(H, W)
    depth_of = lambda d: float(K[0, 0]) * hint_data.BASELINE / d
    cands = np.stack([np.full((H, W), depth_of(d), np.float32)
                      for d in HINT_SHIFTS])
    full = make_scene(1, H, W + HINT_TRUE_SHIFT, seed=SEED + 140)[0]
    left, right = full[:, :W], full[:, HINT_TRUE_SHIFT:]
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -hint_data.BASELINE
    n = len(HINT_SHIFTS)
    rep = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(a, (n,) + a.shape))).to(dev)
    K4, invK4 = hint_data.scaled_K(H, W)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fused, losses = hint_data.fuse_candidates(
        torch.from_numpy(cands).to(dev)[..., None], rep(left), rep(right),
        rep(K4), rep(invK4.astype(np.float32)), rep(T))
    ev[1].record()
    ev[1].synchronize()
    fused = fused[..., 0].cpu().numpy()
    best2 = losses[..., 0].sort(dim=0).values[:2].cpu().numpy()
    ties = (best2[1] - best2[0]) <= HINT_TIE * best2[0]
    step = np.abs(np.diff(left, axis=1)).mean(-1)
    step = np.pad(step, ((0, 0), (0, 1)))
    # a step between columns x - 1 | x or x | x + 1 of rows y - 1 .. y + 1:
    # one inside the pixel's SSIM window
    win = np.max(np.stack([np.roll(np.roll(step, dy, 0), dx, 1)
                           for dy in (-1, 0, 1) for dx in (0, 1)]), 0)
    textured = win > 0.02
    textured[:, :16] = textured[:, -16:] = False
    textured[:2] = textured[-2:] = False
    right_shift = fused[textured] == np.float32(depth_of(HINT_TRUE_SHIFT))
    api = hint_data.fuse_depths(cands, left, right, T, H, W, device=dev)
    log(f"family 14a hints: fuse_candidates of {n} candidate depths at "
        f"{W}x{H} on the card: {ev[0].elapsed_time(ev[1]):.3f} ms (CUDA "
        f"events, first call); the true shift {HINT_TRUE_SHIFT} picked on "
        f"{int(right_shift.sum())} of {int(textured.sum())} textured "
        f"pixels; argmin ties (best two within {HINT_TIE} relative) "
        f"{int(ties.sum())} of {H * W} pixels, {int(ties[textured].sum())} "
        f"of them textured; fuse_depths equal to it: "
        f"{bool(np.array_equal(api, fused))}")
    if not right_shift.all() or not np.array_equal(api, fused) or \
            not textured.sum() > 0.1 * H * W:
        raise AssertionError("the fused hint misses the true shift")
    frames, side, flip, scene = inputs
    stereo = stereo_T_batch(side, flip).cpu().numpy()
    hints = []
    for b in range(side.shape[0]):
        view = lambda f: bilinear_resize(
            (f[b:b + 1].flip(2) if bool(flip[b]) else f[b:b + 1]), H,
            W)[0].cpu().numpy()
        hints.append(hint_data.fuse_depths(cands, view(frames["0"]),
                                           view(frames["s"]), stereo[b], H,
                                           W, device=dev))
    hint = torch.from_numpy(np.stack(hints)[..., None]).to(dev)
    frames = dict(frames, depth_hint=hint, depth_hint_mask=(hint > 0).float())
    picked = np.unique(np.stack(hints), return_counts=True)
    log(f"  batch hints: {side.shape[0]} items fused on the card; depths "
        f"picked (value: pixels) {dict(zip(picked[0].round(4).tolist(), picked[1].tolist()))}")
    return frames, side, flip, scene


def phase_families(dev):
    """Phase 14: the model families (14a-c) and ManyDepth's evaluation
    (14d); returns the launch counts of their timed steps, summed."""
    obj, mask = make_car_object(300, 200, seed=SEED)
    total, manydepth_sd = {}, None
    for i, (label, family, frame_ids) in enumerate(FAMILY_RUNS):
        cfg = dataclasses.replace(_cli_cfg(frame_ids), **family)
        sd, top, rel = calibrated_family(dev, cfg, SEED + 130 + i)
        log(f"family {label}: {_family_name(cfg)}: seeded float32 weights, "
            f"BatchNorm statistics calibrated on 4 synthetic scenes at "
            f"{cfg.selfsup.width}x{cfg.selfsup.height}: deepest feature max "
            f"|f4| {top:.4f}, bf16 eval disp0 {rel:.4e} relative L2 from the "
            f"float32 one" + (" (bf16 out of range)" if rel > 0.05 else ""))
        f32_all, bf16_all = FAMILY_GRAD_L2_ALL.get(
            label, (HARDEN_GRAD_L2_ALL, BENCH_GRAD_L2_ALL))
        phase_harden_parity(dev, frame_ids, family=family, sd=sd,
                            grad_l2_all=f32_all)
        phase_cli_bf16_parity(dev, sd, family=family, readings=(
            "supervised",), frame_ids=frame_ids, grad_l2_all=bf16_all)
        trainer = _harden_trainer(dev, cfg, sd, obj, mask, SEED + 134)
        inputs = _harden_inputs(dev, cfg, SEED + 135)
        if cfg.use_depth_hints:
            inputs = phase_family_hints(dev, cfg, inputs)
        state, launches = phase_cli_run(label, trainer, inputs,
                                        FAMILY_TIMED,
                                        "the same seeded weights")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if cfg.model_family == "manydepth" and not cfg.manydepth_real_lookup:
            manydepth_sd = sd
        del state, trainer, inputs
        torch.cuda.empty_cache()
    for k, v in phase_manydepth_eval(dev, manydepth_sd).items():
        total[k] = total.get(k, 0) + v
    return total


def phase_manydepth_eval(dev, sd):
    """14d: `load_manydepth_reference` from a weights folder written under
    build/manydepth_smoke/ from 14b's weights (metadata 640x192, bins 0.1
    to 20), then `ManyDepthModel` in eval mode at batch 12: single-frame
    (zero lookups through the general path) and `multi_frame`. The card
    against the CPU on 2 items; 2 warm-up and 5 timed forwards of each
    with the launch counters reset before the timed ones (a forward pools
    once, over the current and lookup frames, and runs D's 4 scale-0
    convs); s/forward, peak memory; one profiled multi-frame forward:
    idle share and device ms by kernel. Returns the launches."""
    e = MANYDEPTH_EVAL
    root = os.path.join(REPO, "build", "manydepth_smoke")
    shutil.rmtree(root, ignore_errors=True)
    folder = checkpoints.export_manydepth_reference(
        root, 0, sd, height=e["height"], width=e["width"],
        min_depth_bin=e["min_depth_bin"], max_depth_bin=e["max_depth_bin"])
    cpu_model, meta = checkpoints.load_manydepth_reference(folder,
                                                           device="cpu")
    model, _ = checkpoints.load_manydepth_reference(folder, device=dev)
    shutil.rmtree(root, ignore_errors=True)
    B, H, W = e["batch"], e["height"], e["width"]
    x = bilinear_resize(torch.from_numpy(make_scene(B, 375, 1242,
                                                    seed=SEED + 150)), H, W)
    look = torch.roll(x, 4, dims=2)[:, None]
    pose = torch.eye(4).repeat(B, 1, 1)
    pose[:, 0, 3] = 0.1
    K, invK = quarter_intrinsics(MONODEPTH2_K, H, W)
    args = lambda d, n: dict(K=K.expand(n, 4, 4).to(d),
                             invK=invK.expand(n, 4, 4).to(d),
                             min_depth_bin=meta["min_depth_bin"],
                             max_depth_bin=meta["max_depth_bin"])
    runs = {"single": lambda m, d, n: (m(x[:n].to(d), **args(d, n)),),
            "multi": lambda m, d, n: m.multi_frame(
                x[:n].to(d), look[:n].to(d), pose[:n, None].to(d),
                **args(d, n))}
    out, launches = {}, {k.name: 0 for k in _build.KERNELS}
    for mode, run in runs.items():
        with torch.no_grad():
            cpu = run(cpu_model, torch.device("cpu"), 2)
            got = [t.cpu() for t in run(model, dev, 2)]
        disp_err = float((got[0] - cpu[0]).abs().max())
        splits = [float((g != c).float().mean()) for g, c in
                  zip(got[1:], cpu[1:])]
        with torch.no_grad():
            for n in range(EVAL_WARMUP + EVAL_TIMED):
                if n == EVAL_WARMUP:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    _build.reset_launches()
                    t0 = time.perf_counter()
                run(model, dev, B)
            torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / EVAL_TIMED
        counted = {k.name: k.launches for k in _build.KERNELS}
        predicted = {k.name: 0 for k in _build.KERNELS}
        predicted.update(maxpool3x3s2_fwd=EVAL_TIMED,
                         conv3x3_fwd=4 * EVAL_TIMED)
        log(f"family 14d {mode}: load_manydepth_reference (metadata "
            f"{json.dumps({k: v for k, v in meta.items()})}) + "
            f"ManyDepthModel at {W}x{H} batch {B}, 96 bins: card vs CPU on "
            f"2 items: disp0 max |difference| {disp_err:.3e} (max "
            f"{EVAL_DISP_ATOL}), lowest_cost and confidence differ on "
            f"{json.dumps(splits)} of their pixels (max {EVAL_SPLIT_MAX}); "
            f"{secs:.4f} s per forward (host clock around {EVAL_TIMED} "
            f"after {EVAL_WARMUP} warm-up, synchronised), "
            f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} "
            f"B; launches {json.dumps(counted)}")
        if counted != predicted or not disp_err <= EVAL_DISP_ATOL or \
                not all(sp <= EVAL_SPLIT_MAX for sp in splits) or \
                not bool(torch.isfinite(got[0]).all()):
            raise AssertionError(f"ManyDepth's {mode} evaluation failed")
        for k, v in counted.items():
            launches[k] += v
        out[mode] = got
    with torch.no_grad():
        busy_ms, wall_ms, n, by_name, counts = device_busy(
            lambda: runs["multi"](model, dev, B))
    log(f"  idle: one multi-frame forward under the profiler: device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n} device activities")
    log_kernel_ms(by_name, counts)
    return launches


# -- phase 15 ----------------------------------------------------------------
# the port's command line (cli/main.py) on KITTI-layout trees that the
# phase writes at native size (tests/kitti_trees.py, standard-library
# PNGs): a raw drive of CLI_FRAMES frame indices (train_files: both eyes
# of each, 64 lines, two steps at train-hardening's batch 32; the first
# CLI_TEST_FRAMES as eigen's test_files, with velodyne scans), a KITTI
# object tree of CLI_SCENES scenes (two attack batches of 12), the
# 300x200 car and a reference weights folder of the golden weights with
# calibrated statistics (phase 12's teacher)
CLI_FRAMES, CLI_TEST_FRAMES, CLI_SCENES = 32, 8, 24
CLI_PRESETS = ("l0_thresh01", "linf_eps01")
CLI_EVAL_COUNT = 2
CLI_DISTILL_SCENES = 32  # two batches of train-distill's default batch 16
CLI_PROFILED_STEP = 3  # the resumed run's second step


def _kitti_trees():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import kitti_trees

    return kitti_trees


def phase_cli_files(dev, root):
    """The trees, the split source, the car and the weights folder under
    `root`; a namespace of their paths."""
    kt = _kitti_trees()
    t0 = time.perf_counter()
    raw, drive = kt.write_raw_tree(
        os.path.join(root, "raw"), CLI_FRAMES, 375, 1242, seed=SEED + 200,
        velodyne=range(CLI_TEST_FRAMES))
    src = os.path.join(root, "splits_src")
    test = [f"{drive} {fr} l" for fr in range(CLI_TEST_FRAMES)]
    kt.write_split(src, "eigen_full", train=[
        f"{drive} {fr} {side}" for fr in range(CLI_FRAMES)
        for side in ("l", "r")], val=test)
    kt.write_split(src, "eigen", test=test)
    obj = os.path.join(root, "object")
    names = kt.write_object_tree(obj, CLI_SCENES, 375, 1242, seed=SEED + 240)
    with open(os.path.join(obj, "distill_train.txt"), "w") as f:
        f.write("\n".join((names * 2)[:CLI_DISTILL_SCENES]) + "\n")
    car = kt.write_car(os.path.join(root, "BMW.png"), 300, 200, seed=SEED)
    _, sd = _golden_weights()
    weights = checkpoints.export_reference_pth(
        root, "cli", calibrated_teacher(dev, sd), height=320, width=1024)
    log(f"cli files: raw drive {CLI_FRAMES} frames x 2 eyes at 1242x375, "
        f"{CLI_TEST_FRAMES} velodyne scans, {CLI_SCENES} object scenes, car "
        f"300x200, weights folder of the calibrated golden weights: "
        f"{time.perf_counter() - t0:.1f} s on the host")
    return types.SimpleNamespace(
        root=root, raw=raw, drive=drive, src=src, splits=os.path.join(
            root, "splits"), obj=obj, car=car, weights=weights)


class _CliRuns:
    """The CLI's subcommands through `cli.main.main(argv)` on the card:
    each one's wall seconds (synchronised) and launches (counters reset
    before, read after), summed into `total` (the phase's launches)."""

    def __init__(self):
        self.total = {k.name: 0 for k in _build.KERNELS}
        self.seconds = {}

    def __call__(self, name, argv):
        from depthmodelhardening_tpu_torch.cli import main as cli_main

        torch.cuda.synchronize()
        _build.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli_main.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _build.KERNELS}
        for k, v in launches.items():
            self.total[k] += v
        self.seconds[name] = self.seconds.get(name, 0.0) + secs
        for line in out.getvalue().splitlines()[-12:]:
            log(f"    | {line}")
        log(f"  {name}: {secs:.3f} s wall (synchronised); launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        return result, launches, out.getvalue()


def _expect_launches(name, launches, want) -> None:
    full = {k.name: 0 for k in _build.KERNELS}
    full.update(want)
    if launches != full:
        raise AssertionError(f"cli {name}: launches "
                             f"{json.dumps(launches)}, predicted "
                             f"{json.dumps(full)}")


def _finite(name, values) -> None:
    values = list(values)
    if not values or not all(math.isfinite(float(v)) for v in values):
        raise AssertionError(f"cli {name}: non-finite or no values "
                             f"{values}")


def _jsonl(log_dir):
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def phase_cli_commands(dev, root):
    """Phase 15: the port's command line on files written under `root`;
    returns its launches and the namespace of its files, which also
    holds train-hardening's first step and the direct runs' spread
    (phase 16 reads them)."""
    from depthmodelhardening_tpu_torch import native

    log(f"cli: image decoding route {native.decoder()}")
    runs = _CliRuns()
    f = phase_cli_files(dev, root)
    runs("fetch-splits --from-dir", ["fetch-splits", "--dest", f.splits,
                                     "--from-dir", f.src])
    runs("fetch-splits --generate-odom", ["fetch-splits", "--dest",
                                          f.splits, "--generate-odom"])
    for name in ("eigen_full/train_files.txt", "eigen/test_files.txt",
                 "odom/test_files_10.txt"):
        if not os.path.isfile(os.path.join(f.splits, name)):
            raise AssertionError(f"cli fetch-splits: no {name}")
    runs("export-gt-depths", ["export-gt-depths", "--data-path", f.raw,
                              "--split-dir", f.splits])
    phase_cli_eval(runs, f)
    phase_cli_train(runs, f, dev)
    phase_cli_distill(runs, f)
    phase_cli_extras(runs, f)
    log("  wall seconds by subcommand: " + json.dumps(
        {k: round(v, 3) for k, v in runs.seconds.items()}))
    return runs.total, f


def phase_cli_eval(runs, f) -> None:
    """eval-clean on the 8 test lines and eval-attacks with an L0 and an
    L-inf preset, --eval-count 2, at the CLI's 1024x320, the launches
    against the forwards and `zoo_launches` of each batch."""
    gt = np.load(os.path.join(f.splits, "eigen", "gt_depths.npz"),
                 allow_pickle=True)["data"]
    valid = [int((np.asarray(g) > 0).sum()) for g in gt]
    if len(gt) != CLI_TEST_FRAMES or min(valid) < 100:
        raise AssertionError(f"cli export-gt-depths: {len(gt)} maps, "
                             f"valid pixels {valid}")
    metrics, launches, _ = runs("eval-clean", [
        "eval-clean", "--data-path", f.raw, "--split-dir", f.splits,
        "--weights-folder", f.weights])
    log(f"  eval-clean metrics {json.dumps(metrics)} (valid gt pixels "
        f"{valid})")
    _finite("eval-clean", metrics.values())
    _expect_launches("eval-clean", launches, {
        "maxpool3x3s2_fwd": CLI_TEST_FRAMES,
        "conv3x3_fwd": 4 * CLI_TEST_FRAMES})
    iterations = []
    orig_call = L0ObjectAttack.__call__

    def counting(self, *a, **kw):
        out = orig_call(self, *a, **kw)
        iterations.append(self.last_iterations)
        return out

    L0ObjectAttack.__call__ = counting
    try:
        for preset in CLI_PRESETS:
            iterations.clear()
            res, launches, _ = runs(f"eval-attacks --preset {preset}", [
                "eval-attacks", "--preset", preset, "--object-data-root",
                f.obj, "--object-image", f.car, "--weights-folder",
                f.weights, "--eval-count", str(CLI_EVAL_COUNT)])
            cfg = dataclasses.replace(EVAL_PRESETS[preset],
                                      eval_count=CLI_EVAL_COUNT)
            want = {}
            for i in range(CLI_EVAL_COUNT):
                its = iterations[i] if cfg.norm_type == "l_0" else 0
                for k, v in zoo_launches(cfg, its).items():
                    want[k] = want.get(k, 0) + v
            log(f"  {preset} ({cfg.norm_type}, batch {cfg.batch_size}, "
                f"{CLI_EVAL_COUNT} batches; L0 iterations {iterations}): "
                f"mean {json.dumps(res['mean'])}")
            _finite(preset, list(res["mean"].values())
                    + list(res["max"].values()))
            _expect_launches(preset, launches, want)
    finally:
        L0ObjectAttack.__call__ = orig_call


def _step_recorder(records, waits, profiled_at):
    """Patches, from outside the package, `HardeningTrainer.train_step`
    (host seconds synchronised, launches by difference of the counters,
    L0 iterations, the first step's inputs and the state after it, one
    step under the profiler) and `PrefetchLoader.__iter__` (the seconds
    each batch took to come). Returns the undo."""
    from depthmodelhardening_tpu_torch.data.loader import PrefetchLoader

    orig_step, orig_iter = HardeningTrainer.train_step, \
        PrefetchLoader.__iter__

    def step(self, state, frames, side, flip, scenes, draws=None):
        n = len(records)
        rec = {}
        if n == 0:
            rec["trainer"] = self
            rec["inputs"] = ({k: v.clone() for k, v in frames.items()},
                             side.clone(), flip.clone(),
                             scenes.clone() if torch.is_tensor(scenes)
                             else np.array(scenes))
        counts = {k.name: k.launches for k in _build.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if n == profiled_at:
            out = []
            rec["busy"] = device_busy(lambda: out.append(orig_step(
                self, state, frames, side, flip, scenes, draws)))
            state, metrics = out[0]
        else:
            state, metrics = orig_step(self, state, frames, side, flip,
                                       scenes, draws)
        torch.cuda.synchronize()
        rec["secs"] = time.perf_counter() - t0
        rec["launches"] = {k.name: k.launches - counts[k.name]
                           for k in _build.KERNELS}
        rec["iterations"] = self.attack.last_iterations
        rec["loss"] = float(metrics["loss"])
        if n == 0:
            rec["outcome"] = _step_outcome(self, state, metrics)
        records.append(rec)
        return state, metrics

    def timed_iter(self):
        it = orig_iter(self)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield batch

    HardeningTrainer.train_step, PrefetchLoader.__iter__ = step, timed_iter

    def undo():
        HardeningTrainer.train_step = orig_step
        PrefetchLoader.__iter__ = orig_iter

    return undo


def _half_outcome(state, metrics) -> dict:
    """What one step did to the state: its loss, the gradients (Adam's
    first moment after one step is 0.1 g), the running statistics and
    the parameters, each flattened."""
    flat = lambda ts: torch.cat([t.detach().flatten().float() for t in ts])
    opt = state.optimizer.state
    tensors = _state_tensors(state)
    return {
        "loss": float(metrics["loss"]),
        "grads": flat(opt[p]["exp_avg"] for _, p in _named_params(state)
                      if p in opt),
        "stats": flat(v for k, v in tensors.items()
                      if k.endswith(("running_mean", "running_var"))),
        "params": flat(p for _, p in _named_params(state))}


def _on_host(outcome) -> dict:
    return {k: v.cpu() if torch.is_tensor(v) else v
            for k, v in outcome.items()}


def _step_outcome(trainer, state, metrics) -> dict:
    """`_half_outcome`, the L0 iterations and the generators' states."""
    return {**_half_outcome(state, metrics),
            "iterations": trainer.attack.last_iterations,
            "generators": (trainer.generator.get_state(),
                           trainer.noise_generator.get_state())}


def _outcome_distance(a, b) -> dict:
    rel = lambda k: float((a[k] - b[k]).norm() / b[k].norm())
    return {"loss": abs(a["loss"] - b["loss"]), "grads": rel("grads"),
            "stats": rel("stats"),
            "params": float((a["params"] - b["params"]).abs().max())}


def phase_cli_train(runs, f, dev) -> None:
    """train-hardening --fine-tune at the CLI's defaults (bf16, L0, frames
    0,s, batch 32, attack batch 12, a robustness val at step 0) with
    --epochs 1 --log-frequency 1, then the same command again, which
    resumes at step 2: s/step, loader waits, launches a step against
    `harden_launches`, the idle share of one step, peak memory, the
    JSONL, checkpoints and opt.json; the first step against direct
    `train_step`s of trainers built from the same seed."""
    log_dir = os.path.join(f.root, "hardening")
    argv = ["train-hardening", "--data-path", f.raw, "--split-dir",
            f.splits, "--object-data-root", f.obj, "--object-image", f.car,
            "--weights-folder", f.weights, "--fine-tune", "--epochs", "1",
            "--log-frequency", "1", "--log-dir", log_dir]
    records, waits = [], []
    undo = _step_recorder(records, waits, CLI_PROFILED_STEP)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        outs = [runs(f"train-hardening ({run})", argv)[2]
                for run in ("first run", "resumed")]
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated(dev)
    rows = _jsonl(log_dir)
    keys = set().union(*rows)
    secs = [r["secs"] for r in records]
    timed = [s for i, s in enumerate(secs) if i != CLI_PROFILED_STEP]
    busy_ms, wall_ms, n_act, by_name, counts = records[
        CLI_PROFILED_STEP]["busy"]
    log(f"  train-hardening: {len(records)} steps; seconds a step (host "
        f"clock around train_step, synchronised) {json.dumps(secs)}, "
        f"median of the unprofiled {float(np.median(timed)):.4f}; loader "
        f"wait a batch (s) {json.dumps([round(w, 4) for w in waits])}; L0 "
        f"iterations {[r['iterations'] for r in records]}; losses "
        f"{[r['loss'] for r in records]}; peak max_memory_allocated {peak} B")
    log(f"  idle: step {CLI_PROFILED_STEP} under the profiler: device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms host wall, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n_act} device activities")
    log_kernel_ms(by_name, counts)
    for i, r in enumerate(records):
        _expect_launches(f"train-hardening step {i}", r["launches"],
                         harden_launches(r["iterations"], bf16=True))
    if len(records) != 4 or "resumed from step 2" not in outs[1] or \
            "resumed" in outs[0]:
        raise AssertionError("cli train-hardening: 2 + 2 steps, the second "
                             "run resuming at step 2, expected")
    if not {"loss", "val/mean_abs_err", "sup_loss", "contras_loss",
            "selfsup_loss"} <= keys:
        raise AssertionError(f"cli train-hardening: JSONL keys {keys}")
    _finite("train-hardening", [v for r in rows for v in r.values()])
    for path in ("ckpts/2/state.pt", "ckpts/4/state.pt", "opt.json"):
        if not os.path.isfile(os.path.join(log_dir, path)):
            raise AssertionError(f"cli train-hardening: no {path}")
    f.secs = timed
    phase_cli_first_step(records[0], f, dev)


def phase_cli_first_step(first, f, dev) -> None:
    """The CLI's first step against two direct `train_step`s, each of a
    trainer built from the same seed (17, the CLI's) on the loader batch
    and the scene batch the CLI passed, bit for bit (the two direct steps
    are phase 18's pair); that loader batch against the first batch of a
    loader built here on the same split and seed."""
    from depthmodelhardening_tpu_torch.data.kitti_raw import (
        KittiRawDataset, collate, load_split,
    )
    from depthmodelhardening_tpu_torch.data.loader import PrefetchLoader

    t = first["trainer"]
    frames, side, flip, scenes = first["inputs"]
    ds = KittiRawDataset(f.raw, load_split(f.splits, "eigen_full"),
                         t.cfg.selfsup.frame_ids, t.cfg.adv.ori_h,
                         t.cfg.adv.ori_w)
    batch = next(iter(PrefetchLoader(ds, t.cfg.batch_size, collate,
                                     seed=17, device=dev)))
    same = all(torch.equal(batch["frames"][k], frames[k]) for k in frames) \
        and torch.equal(batch["side_is_l"], side) and \
        torch.equal(batch["do_flip"], flip)
    direct, runs = [], []
    for _ in range(2):
        tr = HardeningTrainer(
            t.cfg, torch.Generator().manual_seed(17), t.obj_img, t.obj_mask,
            t.teacher, device=dev,
            steps_per_epoch=t.transition_steps // t.cfg.scheduler_step_size,
            init_state_dict=t._init_state_dict)
        with _keeping(tr, "refresh_texture", []) as tex:
            state, m = tr.train_step(tr.make_state(), frames, side, flip,
                                     scenes)
        direct.append(_step_outcome(tr, state, m))
        runs.append(outcome(_state_modules(state), m, texture=tex[0],
                            l0_iterations=[tr.attack.last_iterations]))
        del tr, state
    record_repeat("15a", *runs)  # phase 18's pair
    del runs
    cli = first["outcome"]
    spread = _outcome_distance(direct[1], direct[0])
    dist = _outcome_distance(cli, direct[0])
    gens = all(torch.equal(a, b) for a, b in zip(cli["generators"],
                                                 direct[0]["generators"]))
    log(f"  first step against direct train_steps (loader batch as a "
        f"loader built here gives it: {same}; generator states equal: "
        f"{gens}): loss CLI {cli['loss']:.9e}, direct {direct[0]['loss']:.9e}"
        f" / {direct[1]['loss']:.9e}; L0 iterations {cli['iterations']} / "
        f"{direct[0]['iterations']} / {direct[1]['iterations']}; CLI vs "
        f"direct {json.dumps(dist)}; direct vs direct {json.dumps(spread)}")
    if not (same and gens and all(v == 0 for v in dist.values())):
        raise AssertionError("cli train-hardening: the first step is not "
                             "the direct step bit for bit")
    f.first, f.spread = first, spread
    log("  held: bit for bit")


def phase_cli_distill(runs, f) -> None:
    """train-distill --epochs 1 --eval-count 1 at its defaults (bf16
    student, float32 disp0 teacher, batch 16, PGD-10) on a scene list of
    two batches: the JSONL, opt.json and the weights folders; A, B-bf16,
    D-bf16 and float32 D launched."""
    log_dir = os.path.join(f.root, "distill")
    state, launches, _ = runs("train-distill", [
        "train-distill", "--object-data-root", f.obj, "--object-image",
        f.car, "--weights-folder", f.weights, "--epochs", "1",
        "--eval-count", "1", "--train-list", "distill_train.txt",
        "--log-dir", log_dir])
    rows = _jsonl(log_dir)
    keys = set().union(*rows)
    log(f"  train-distill: {state.step} steps; rows {json.dumps(rows)}")
    _finite("train-distill", [v for r in rows for v in r.values()])
    if state.step != 2 or not {"loss", "eval/atk_perf",
                               "eval/model_perf"} <= keys:
        raise AssertionError(f"cli train-distill: {state.step} steps, "
                             f"keys {keys}")
    for path in ("opt.json", "weights_1/encoder.pth",
                 "weights_final/depth.pth"):
        if not os.path.isfile(os.path.join(log_dir, path)):
            raise AssertionError(f"cli train-distill: no {path}")
    quiet = [k for k in ("vertical_resample_fwd", "vertical_resample_bwd",
                         "maxpool3x3s2_fwd_bf16", "maxpool3x3s2_bwd_bf16",
                         "conv3x3_fwd_bf16", "conv3x3_dgrad_bf16",
                         "conv3x3_fwd") if launches[k] <= 0]
    if quiet:
        raise AssertionError(f"cli train-distill: never launched {quiet}")


def phase_cli_extras(runs, f) -> None:
    """infer where PIL imports (one forward at 1024x320: B 1, D 4),
    precompute-hints where cv2 and PIL import (two frames, one each eye:
    the SGBM hints fused on the card, kernel C once a hint), and
    eval-attacks --dump-dir where PIL and matplotlib import; otherwise a
    line says which was not run and why."""
    phase_cli_hints(runs, f)
    missing = [m for m in ("PIL", "matplotlib")
               if importlib.util.find_spec(m) is None]
    image = os.path.join(f.raw, f.drive, "image_02", "data",
                         "0000000000.png")
    if "PIL" in missing:
        log("  infer: not run, PIL is not installed")
    else:
        from depthmodelhardening_tpu_torch.native import load_image

        disp, launches, _ = runs("infer", ["infer", "--image", image,
                                           "--weights-folder", f.weights])
        size = load_image(image).shape[:2]
        if disp.shape != (1, *size, 1) or not np.isfinite(disp).all():
            raise AssertionError(f"cli infer: {disp.shape} for {size}")
        _expect_launches("infer", launches, {"maxpool3x3s2_fwd": 1,
                                             "conv3x3_fwd": 4})
    if missing:
        log(f"  eval-attacks --dump-dir: not run, "
            f"{' and '.join(missing)} not installed")
        return
    dump = os.path.join(f.root, "dumps")
    runs("eval-attacks --dump-dir", [
        "eval-attacks", "--preset", "linf_eps01", "--object-data-root",
        f.obj, "--object-image", f.car, "--weights-folder", f.weights,
        "--eval-count", "1", "--dump-dir", dump])
    if sorted(os.listdir(dump)) != ["adv_000.png", "ben_000.png",
                                    "panel_000.png"]:
        raise AssertionError(f"cli --dump-dir: {os.listdir(dump)}")


def phase_cli_hints(runs, f) -> None:
    """precompute-hints on two lines of the raw drive (frame 0 left, 1
    right) into f.root/hints: one (1, 320, 1024) float32 file each,
    finite, positive where a depth was found; C launched once a hint."""
    missing = [m for m in ("cv2", "PIL")
               if importlib.util.find_spec(m) is None]
    if missing:
        log(f"  precompute-hints: not run, {' and '.join(missing)} not "
            f"installed")
        return
    lines = os.path.join(f.root, "hint_files.txt")
    with open(lines, "w") as fh:
        fh.write(f"{f.drive} 0 l\n{f.drive} 1 r\n")
    save = os.path.join(f.root, "hints")
    written, launches, _ = runs("precompute-hints", [
        "precompute-hints", "--data-path", f.raw, "--filenames", lines,
        "--save-path", save])
    hints = [np.load(p) for p in written]
    log(f"  precompute-hints: {len(written)} files "
        f"{[os.path.relpath(p, save) for p in written]}, shapes "
        f"{[h.shape for h in hints]}, valid share "
        f"{[round(float((h > 0).mean()), 4) for h in hints]}")
    if len(hints) != 2 or any(h.shape != (1, 320, 1024) or h.dtype !=
                              np.float32 or not np.isfinite(h).all() or
                              not (h > 0).any() for h in hints):
        raise AssertionError("cli precompute-hints: bad hint files")
    _expect_launches("precompute-hints", launches, {"reproj_loss_fwd": 2})


# -- phase 16 ----------------------------------------------------------------
# data parallelism (`parallel/`, the trainers' mesh=, --data-parallel):
# 16a two ranks on the one card over gloo (NCCL refuses two ranks on one
# card) at the CLI's configuration, each rank a child process joined with
# a timeout, its group through a file store with a DP_GROUP_TIMEOUT;
# 16b the CLI's --data-parallel over NCCL at world size 1 on phase 15's
# tree; 16c the JAX
# package's two longitudinal checks (tests/test_convergence.py) at their
# shapes and with their assertions; 16d the zoo loader onto the card
DP_WORLD, DP_TIMEOUT, DP_GROUP_TIMEOUT = 2, 400, 60
DP_SEED = SEED + 300
DP_WORK = os.path.join(REPO, "build", "dp_smoke")
# The training half under a mesh is held against one process's on the
# same inputs in float32 (phase 11's student; the teacher is float32
# either way): within DP_SPREAD_X times the larger of the one
# process's two-run spread and its spread with every weight one ulp away
# (phase 11's rule), with floors for what two runs keep bit-equal (the
# loss, the running statistics: the global BatchNorm sums in another
# order than nn.BatchNorm2d; on the CPU 1e-7 relative at world size 1,
# 2.2e-5 on two ranks at batch 4, tests/test_torch_parallel.py's
# STEP_STATS 1e-4). Each of DP_FAULTS, planted on the ranks, must fail
# that rule, or it could not tell a fault from rounding. In bf16 (the
# CLI's student) one ulp of the weights moves the gradients by 0.35-1.07
# relative L2, so no spread there tells a fault from rounding: the bf16
# gradients are printed, and only the loss and the running statistics
# are held, by the same rule.
DP_SPREAD_X, DP_LOSS_RTOL, DP_STATS_FLOOR = 2.0, 1e-5, 1e-4
DP_FAULTS = ("gradient mean skipped", "BatchNorm over the rank's rows")
CONVERGE_H, CONVERGE_W, CONVERGE_ORI = 64, 192, (96, 320)


def _within_spread(dist, spread, loss,
                   keys=("grads", "stats", "loss")) -> bool:
    bound = {"grads": DP_SPREAD_X * spread["grads"],
             "stats": max(DP_SPREAD_X * spread["stats"], DP_STATS_FLOOR),
             "loss": max(DP_SPREAD_X * spread["loss"],
                         DP_LOSS_RTOL * abs(loss))}
    return all(dist[k] <= bound[k] for k in keys)


def _nudge_state(state, seed) -> None:
    """Every weight and statistic of the state's modules one ulp away."""
    for i, m in enumerate(state.modules().values()):
        m.load_state_dict(_ulp_nudged(
            {k: v.cpu() for k, v in m.state_dict().items()}, seed + i))


class _GradMeanSkipped(Mesh):
    """A mesh whose `all_mean` leaves its tensors as they are (a planted
    fault: each rank keeps its own gradients and metrics)."""

    def all_mean(self, tensors):
        return list(tensors)


def _dp_half(trainer, inputs, rows=slice(None), nudge=None, fault=None):
    """The training half (`synth_batch` + `_update`) of a fresh state on
    the inputs' texture, this rank's `rows`, every weight one ulp away
    with `nudge` (a seed), one of DP_FAULTS planted with `fault`; returns
    (state, metrics)."""
    dev, mesh = trainer.device, trainer.mesh
    try:
        if fault == DP_FAULTS[1]:
            trainer.mesh = None  # make_state keeps nn.BatchNorm2d
        state = trainer.make_state()
        trainer.mesh = mesh
        if fault == DP_FAULTS[0]:
            trainer.mesh = _GradMeanSkipped(mesh.rank, mesh.world_size,
                                            mesh.device, mesh.group)
        if nudge is not None:
            _nudge_state(state, nudge)
        frames = {k: v[rows].to(dev) for k, v in inputs["frames"].items()}
        batch = trainer.synth_batch(frames, inputs["side"][rows].to(dev),
                                    inputs["flip"][rows].to(dev),
                                    inputs["texture"].to(dev),
                                    inputs["draws"])
        return trainer._update(state, batch, inputs["draws"].identity_noise)
    finally:
        trainer.mesh = mesh


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def dp_rank(rank: int, device: str) -> None:
    """One rank of 16a (run in a child process by `phase_parallel`): joins
    the gloo group through DP_WORK's file store, then on its rows of the
    inputs 16a wrote: the texture refresh and the bf16 training half on
    the one process's texture (launches counted over both), one timed
    `train_step`, the gradients' all-reduce timed alone; then the float32
    training half, as it is and with each of DP_FAULTS planted; saves
    DP_WORK/rank<rank>.pt."""
    from depthmodelhardening_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(device)
    use_f32_numerics()
    pmesh.initialize_distributed(
        f"file://{DP_WORK}/store", world_size=DP_WORLD, rank=rank,
        backend="gloo", timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
    try:
        mesh = pmesh.make_mesh(dev, backend="gloo")
        inp = torch.load(os.path.join(DP_WORK, "inputs.pt"),
                         weights_only=False)
        cfg = inp["cfg"]
        trainer = _harden_trainer(dev, cfg, inp["cal"], inp["obj"],
                                  inp["mask"], DP_SEED + 2, mesh)
        rows = mesh.rows(cfg.batch_size)
        scenes = inp["scenes"][mesh.rows(cfg.adv.attack_batch_size)].to(dev)
        _sync(dev)
        _build.reset_launches()
        tex = trainer.refresh_texture(trainer.make_state(), scenes,
                                      inp["draws"])
        iterations = trainer.attack.last_iterations
        state, metrics = _dp_half(trainer, inp, rows)
        _sync(dev)
        launches = {k.name: k.launches for k in _build.KERNELS}
        outcome = _half_outcome(state, metrics)
        frames = {k: v[rows].to(dev) for k, v in inp["frames"].items()}
        t0 = time.perf_counter()
        state, _ = trainer.train_step(trainer.make_state(), frames,
                                      inp["side"][rows].to(dev),
                                      inp["flip"][rows].to(dev), scenes,
                                      inp["draws"])
        _sync(dev)
        secs = time.perf_counter() - t0
        grads = [p.grad for _, p in _named_params(state)
                 if p.grad is not None]
        reduce_ms = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            mesh.all_mean(grads)
            _sync(dev)
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        grad_bytes = sum(g.numel() * 4 for g in grads)
        del trainer, state, grads
        trainer = _harden_trainer(dev, inp["cfg32"], inp["cal"], inp["obj"],
                                  inp["mask"], DP_SEED + 2, mesh)
        outcome32 = _on_host(_half_outcome(*_dp_half(trainer, inp, rows)))
        faults32 = {fault: _on_host(_half_outcome(*_dp_half(
            trainer, inp, rows, fault=fault))) for fault in DP_FAULTS}
        torch.save({"texture": tex.cpu(), "iterations": iterations,
                    "launches": launches, "secs": secs,
                    "reduce_ms": reduce_ms, "grad_bytes": grad_bytes,
                    "outcome": _on_host(outcome), "outcome32": outcome32,
                    "faults32": faults32},
                   os.path.join(DP_WORK, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_dp_ranks(dev, cal, obj, mask, spread15):
    """16a: the CLI's step (`_cli_cfg`: bf16 student, float32 teacher,
    L0 10 steps on attack batch 12, frames 0,s, 1024x320) at global batch
    32 on two ranks of the one card over gloo, against the one process
    on the same inputs and injected draws; the training half also with
    the float32 student, as it is and with DP_FAULTS planted. Returns the
    ranks' launches and what 16b compares with: the inputs, the one
    process's float32 half and its spread."""
    cfg = _cli_cfg(("0", "s"))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    B, A = cfg.batch_size, cfg.adv.attack_batch_size
    shutil.rmtree(DP_WORK, ignore_errors=True)
    os.makedirs(DP_WORK)
    frames, side, flip, _ = _harden_inputs(torch.device("cpu"), cfg, DP_SEED)
    scenes = torch.from_numpy(make_scene(A, cfg.adv.ori_h, cfg.adv.ori_w,
                                         seed=DP_SEED + 1))
    trainer = _harden_trainer(dev, cfg, cal, obj, mask, DP_SEED + 2)
    draws = trainer.draw(B, torch.Generator().manual_seed(DP_SEED + 3))
    draws.identity_noise = torch.randn(
        trainer.identity_noise_shape(B),
        generator=torch.Generator().manual_seed(DP_SEED + 4))
    tex = trainer.refresh_texture(trainer.make_state(), scenes.to(dev), draws)
    iterations = trainer.attack.last_iterations
    inputs = dict(cfg=cfg, cfg32=cfg32, cal=cal, obj=obj, mask=mask,
                  frames=frames, side=side, flip=flip, scenes=scenes,
                  draws=draws, texture=tex.cpu())
    torch.save(inputs, os.path.join(DP_WORK, "inputs.pt"))
    logs = [open(os.path.join(DP_WORK, f"rank{r}.log"), "w")
            for r in range(DP_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.dp_rank({r}, {str(dev)!r})"],
        cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(DP_WORLD)]
    try:
        # meanwhile the one process's training half in bf16 and float32,
        # twice each (its spread) and once with every weight one ulp away
        # (phase 11's rule)
        solo = [_on_host(_half_outcome(*_dp_half(trainer, inputs, nudge=n)))
                for n in (None, None, DP_SEED + 5)]
        del trainer
        trainer = _harden_trainer(dev, cfg32, cal, obj, mask, DP_SEED + 2)
        solo32 = [_on_host(_half_outcome(*_dp_half(trainer, inputs,
                                                     nudge=n)))
                  for n in (None, None, DP_SEED + 5)]
        del trainer
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=DP_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 16a: rank {r} hung")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(DP_WORK, f"rank{r}.log")) as f:
            tail = f.read()[-3000:]
        if p.returncode != 0:
            raise AssertionError(f"phase 16a: rank {r} failed "
                                 f"({p.returncode}):\n{tail}")
    ranks = [torch.load(os.path.join(DP_WORK, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    shutil.rmtree(DP_WORK, ignore_errors=True)
    same_tex = torch.equal(ranks[0]["texture"], ranks[1]["texture"])
    split = float((ranks[0]["texture"] != tex.cpu()).float().mean())
    half_spread = _outcome_distance(solo[1], solo[0])
    ulp = _outcome_distance(solo[2], solo[0])
    spread = {k: max(half_spread[k], spread15[k], ulp[k])
              for k in half_spread}
    dists = [_outcome_distance(r["outcome"], solo[0]) for r in ranks]
    two32 = _outcome_distance(solo32[1], solo32[0])
    ulp32 = _outcome_distance(solo32[2], solo32[0])
    spread32 = {k: max(two32[k], ulp32[k]) for k in two32}
    dists32 = [_outcome_distance(r["outcome32"], solo32[0]) for r in ranks]
    faults32 = [{fault: _outcome_distance(r["faults32"][fault], solo32[0])
                 for fault in DP_FAULTS} for r in ranks]
    log(f"dp 16a: two ranks on one card over gloo, {_family_name(cfg)}, "
        f"bf16 student, float32 teacher, global batch {B} ({B // 2} frames "
        f"and {A // 2} attack scenes a rank), L0 steps {cfg.adv.steps}: "
        f"textures equal across ranks {same_tex}; L0 iterations ranks "
        f"{[r['iterations'] for r in ranks]}, one process {iterations}; "
        f"texels where the ranks' texture differs from the one process's "
        f"{split:.4%} (a reading: L0 trajectories part under Adam)")
    log(f"  the bf16 training half on the one process's texture (gradients "
        f"a reading; loss and statistics held): ranks vs one process "
        f"{json.dumps(dists)}, one process vs itself "
        f"{json.dumps(half_spread)}, vs itself with every weight one ulp "
        f"away {json.dumps(ulp)}, phase 15's direct spread "
        f"{json.dumps(spread15)}")
    log(f"  the float32 training half on that texture (held): ranks vs one "
        f"process {json.dumps(dists32)}, one process vs itself "
        f"{json.dumps(two32)}, vs itself with every weight one ulp away "
        f"{json.dumps(ulp32)}; the bound {DP_SPREAD_X} x the larger; "
        f"planted faults (each must fail it) {json.dumps(faults32)}")
    for r, res in enumerate(ranks):
        log(f"  rank {r}: {res['secs']:.4f} s for one train_step (host "
            f"clock, synchronised, two ranks sharing the card: no scaling "
            f"is claimed); the gradients' all-reduce "
            f"({res['grad_bytes']} B over gloo) "
            f"{json.dumps([round(m, 3) for m in res['reduce_ms']])} ms; "
            f"launches {json.dumps({k: v for k, v in res['launches'].items() if v})}")
    bad = [f"rank {r} launches" for r, res in enumerate(ranks)
           if res["launches"] != {**{k.name: 0 for k in _build.KERNELS},
                                  **harden_launches(res["iterations"],
                                                    bf16=True)}]
    if not same_tex:
        bad.append("textures differ across ranks")
    if any(r["iterations"] != iterations for r in ranks):
        bad.append("L0 iterations")
    bad += [f"rank {r}'s bf16 loss or statistics"
            for r, d in enumerate(dists)
            if not _within_spread(d, spread, solo[0]["loss"],
                                  keys=("stats", "loss"))]
    bad += [f"rank {r}'s float32 training half"
            for r, d in enumerate(dists32)
            if not _within_spread(d, spread32, solo32[0]["loss"])]
    bad += [f"rank {r}: the planted fault '{fault}' passes the float32 rule"
            for r, by_fault in enumerate(faults32)
            for fault, d in by_fault.items()
            if _within_spread(d, spread32, solo32[0]["loss"])]
    if bad:
        raise AssertionError(f"phase 16a failed: {bad}")
    launches = {k.name: sum(r["launches"][k.name] for r in ranks)
                for k in _build.KERNELS}
    return launches, {"inputs": inputs, "solo32": solo32[0],
                      "spread32": spread32}


def phase_dp_cli(runs, f, dev, dp) -> None:
    """16b: train-hardening --fine-tune --data-parallel at its defaults on
    phase 15's tree (NCCL, world size 1), 2 steps: each step's launches,
    its first step against phase 15's CLI step (bf16: the gradients a
    reading, the loss and statistics held by phase 15's rule with
    DP_STATS_FLOOR and DP_LOSS_RTOL), rank 0's checkpoint and opt.json;
    s/step beside phase 15's; the gradients' all-reduce timed alone; over
    the same group, 16a's float32 training half (`dp`: its inputs, the
    one process's half and spread) held by 16a's float32 rule."""
    (ulp,) = _direct_steps(f.first, dev, n=1, nudge=DP_SEED + 6)
    ulp = _outcome_distance(ulp, f.first["outcome"])
    spread = {k: max(f.spread[k], ulp[k]) for k in ulp}
    log_dir = os.path.join(f.root, "hardening_dp")
    argv = ["train-hardening", "--data-path", f.raw, "--split-dir",
            f.splits, "--object-data-root", f.obj, "--object-image", f.car,
            "--weights-folder", f.weights, "--fine-tune", "--epochs", "1",
            "--log-frequency", "1", "--log-dir", log_dir, "--data-parallel"]
    records, waits = [], []
    undo = _step_recorder(records, waits, None)
    try:
        state = runs("train-hardening --data-parallel", argv)[0]
        mesh = Mesh(torch.distributed.get_rank(),
                    torch.distributed.get_world_size(), dev)
        backend = torch.distributed.get_backend()
        grads = [p.grad for _, p in _named_params(state)
                 if p.grad is not None]
        reduce_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.all_mean(grads)
            torch.cuda.synchronize()
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        grad_bytes = sum(g.numel() * 4 for g in grads)
        del state, grads
        inp = dp["inputs"]
        trainer = _harden_trainer(dev, inp["cfg32"], inp["cal"], inp["obj"],
                                  inp["mask"], DP_SEED + 2, mesh)
        one32 = _on_host(_half_outcome(*_dp_half(trainer, inp)))
        del trainer
        phase_dp_batchnorm(mesh)
    finally:
        undo()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    dist = _outcome_distance(records[0]["outcome"], f.first["outcome"])
    log(f"  train-hardening --data-parallel ({backend}, world size "
        f"{mesh.world_size}): seconds a step {json.dumps([r['secs'] for r in records])} "
        f"(phase 15's unprofiled steps {json.dumps(f.secs)}); L0 iterations "
        f"{[r['iterations'] for r in records]}; the first step against "
        f"phase 15's {json.dumps(dist)} (phase 15's direct spread "
        f"{json.dumps(f.spread)}; a direct step with every weight one ulp "
        f"away against it {json.dumps(ulp)}); the gradients' all-reduce alone "
        f"({grad_bytes} B) "
        f"{json.dumps([round(m, 3) for m in reduce_ms])} ms")
    dist32 = _outcome_distance(one32, dp["solo32"])
    log(f"  the float32 training half over this group against 16a's one "
        f"process {json.dumps(dist32)} (16a's spread "
        f"{json.dumps(dp['spread32'])}, the bound {DP_SPREAD_X} x it)")
    for i, r in enumerate(records):
        _expect_launches(f"train-hardening --data-parallel step {i}",
                         r["launches"], harden_launches(r["iterations"],
                                                        bf16=True))
    for path in ("ckpts/2/state.pt", "opt.json"):
        if not os.path.isfile(os.path.join(log_dir, path)):
            raise AssertionError(f"cli --data-parallel: no {path}")
    if len(records) != 2 or not _within_spread(
            dist, spread, f.first["outcome"]["loss"], keys=("stats", "loss")):
        raise AssertionError("cli --data-parallel: the first step is not "
                             "phase 15's")
    if not _within_spread(dist32, dp["spread32"], dp["solo32"]["loss"]):
        raise AssertionError("cli --data-parallel: the float32 training "
                             "half at world size 1 is not one process's")


DP_BN_SHAPE = (16, 64, 160, 512)  # the stem's BatchNorm at batch 16


def _exact_batchnorm(x, ct, w, b, eps=1e-5):
    """Train-mode BatchNorm of x and the gradients of sum(y * ct) in
    float64: y, dx, dw, db, the batch mean and unbiased variance."""
    x, ct = x.double(), ct.double()
    w, b = w.double().view(1, -1, 1, 1), b.double().view(1, -1, 1, 1)
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1]
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    xhat = (x - mean) / torch.sqrt(var + eps)
    dxhat = ct * w
    dx = (dxhat - dxhat.mean(dims, keepdim=True) - xhat * (
        dxhat * xhat).mean(dims, keepdim=True)) / torch.sqrt(var + eps)
    return {"y": xhat * w + b, "dx": dx, "dw": (ct * xhat).sum(dims),
            "db": ct.sum(dims), "mean": mean.flatten(),
            "var": var.flatten() * n / (n - 1)}


def phase_dp_batchnorm(mesh) -> None:
    """The global BatchNorm (world size 1 on the card) and nn.BatchNorm2d
    against the exact BatchNorm (`_exact_batchnorm`, float64 on the same
    inputs) at DP_BN_SHAPE, float32 and bf16: the output and the input
    gradient of sum(y * ct) within one rounding of the exact value in
    bf16 (each element, plus 1e-6 of the largest magnitude: float32
    cancels in dx) and 1e-6 relative L2 in float32; the weight and
    bias gradients and the running statistics within 1e-5 relative L2
    (float32 sums of 2.6M terms). nn.BatchNorm2d's readings are logged
    beside, not held."""
    from depthmodelhardening_tpu_torch.parallel.batchnorm import (
        global_batchnorm,
    )

    gen = torch.Generator().manual_seed(DP_SEED + 7)
    C = DP_BN_SHAPE[1]
    x0 = torch.randn(DP_BN_SHAPE, generator=gen) * 2.0 + 0.5
    ct0 = torch.randn(DP_BN_SHAPE, generator=gen)
    w, b = torch.rand(C, generator=gen) + 0.5, torch.randn(C, generator=gen)
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        x, ct = x0.to(mesh.device, dtype), ct0.to(mesh.device, dtype)
        exact = _exact_batchnorm(x, ct, w.to(mesh.device), b.to(mesh.device))
        rel_of = {}
        for label, convert in (("nn.BatchNorm2d", False),
                               ("global BatchNorm", True)):
            bn = torch.nn.BatchNorm2d(C, momentum=None).to(mesh.device)
            with torch.no_grad():
                bn.weight.copy_(w)
                bn.bias.copy_(b)
            if convert:
                bn = global_batchnorm(bn, mesh)
            xr = x.clone().requires_grad_(True)
            y = bn(xr)
            (y.float() * ct.float()).sum().backward()
            got = {"y": y.detach(), "dx": xr.grad, "dw": bn.weight.grad,
                   "db": bn.bias.grad, "mean": bn.running_mean,
                   "var": bn.running_var}
            rel = {k: float((got[k].double() - exact[k]).norm()
                            / exact[k].norm()) for k in exact}
            beyond = {k: float(((got[k].double() - exact[k]).abs()
                                > torch.finfo(dtype).eps * exact[k].abs()
                                + 1e-6 * exact[k].abs().max()).float()
                                .mean()) for k in ("y", "dx")}
            log(f"  {label} (world size 1) at {DP_BN_SHAPE} in "
                f"{str(dtype)[6:]} against the exact BatchNorm in float64: "
                f"relative L2 {json.dumps(rel)}; share of elements beyond "
                f"one rounding {json.dumps(beyond)}")
            rel_of[label] = (rel, beyond)
        rel, beyond = rel_of["global BatchNorm"]
        for k, v in rel.items():
            if k in ("y", "dx"):
                if dtype == torch.bfloat16 and beyond[k] > 0:
                    bad.append(f"{k} in bf16")
                elif dtype == torch.float32 and not v <= 1e-6:
                    bad.append(f"{k} in float32")
            elif not v <= 1e-5:
                bad.append(f"{k} in {str(dtype)[6:]}")
    if bad:
        raise AssertionError(f"the global BatchNorm is not the exact "
                             f"BatchNorm to rounding on the card: {bad}")


def _direct_steps(first, dev, n=2, nudge=None):
    """`n` direct `train_step`s of trainers built as phase 15's first step
    was, on its inputs (every weight one ulp away with `nudge`, a seed);
    their outcomes."""
    t = first["trainer"]
    frames, side, flip, scenes = first["inputs"]
    out = []
    for _ in range(n):
        tr = HardeningTrainer(
            t.cfg, torch.Generator().manual_seed(17), t.obj_img, t.obj_mask,
            t.teacher, device=dev,
            steps_per_epoch=t.transition_steps // t.cfg.scheduler_step_size,
            init_state_dict=t._init_state_dict)
        state = tr.make_state()
        if nudge is not None:
            _nudge_state(state, nudge)
        state, m = tr.train_step(state, frames, side, flip, scenes)
        out.append(_step_outcome(tr, state, m))
        del tr, state
    return out


def _attack_effect(trainer, state, eval_scene, batch_size) -> float:
    """tests/test_convergence.py's `_attack_effect`: mean |depth(adv) -
    depth(ben)| inside the object mask for the in-training student, the
    eval-pinned sample (my_utils.py:31-41)."""
    from depthmodelhardening_tpu_torch.ops.metrics import get_mean_depth_diff

    atk = trainer.attack_student(state)
    adv, ben, masks, _ = atk(eval_scene, batch_size,
                             torch.Generator().manual_seed(7),
                             eval_mode=True)
    with torch.no_grad():
        view = trainer.student_view
        return float(get_mean_depth_diff(view(adv), view(ben), masks,
                                         use_abs=True))


def phase_converge_long(dev) -> None:
    """16c: tests/test_convergence.py on the card with the port, at its
    shapes (64x192, ori 96x320, the 36x24 car), seeds and assertions: 40
    distillation steps lower the mean loss of the last 10 below the first
    10 and the attack effect; 50 hardening steps on
    `make_stereo_pair(4, 96, 320, shift=10, seed=5)` lower the
    self-supervised and supervised losses, and the attack effect grows by
    less than 10%. The teachers are `init_monodepth2` of generators seeded
    as JAX's keys were (flax's initialisation; ROADMAP Queue 3)."""
    from depthmodelhardening_tpu_torch.data.synthetic import make_stereo_pair

    H, W, (OH, OW) = CONVERGE_H, CONVERGE_W, CONVERGE_ORI
    obj, mask = make_car_object(36, 24, seed=0)
    tens = lambda a: torch.from_numpy(a).to(dev)
    eval_scene = tens(make_scene(1, OH, OW, seed=99))
    teacher = init_monodepth2(torch.Generator().manual_seed(0))
    cfg = DistillConfig(adv_type="object", epsilon=0.1, alpha=0.01, steps=3,
                        batch_size=4, scene_h=H, scene_w=W, ori_h=OH,
                        ori_w=OW, learning_rate=1e-3,
                        compute_dtype="float32")
    trainer = DistillTrainer(cfg, torch.Generator().manual_seed(1), obj,
                             mask, predictor_from(teacher.to(dev)),
                             device=dev,
                             init_state_dict=teacher.state_dict())
    state = trainer.make_state()
    before = _attack_effect(trainer, state, eval_scene, cfg.batch_size)
    scenes = tens(make_scene(2, OH, OW, seed=3))
    losses = []
    for step in range(40):
        state, m = trainer.train_step(
            state, scenes[step % 2:step % 2 + 1],
            torch.Generator().manual_seed(100 + step))
        losses.append(float(m["loss"]))
    after = _attack_effect(trainer, state, eval_scene, cfg.batch_size)
    mean = lambda v: float(np.mean(v))
    log(f"converge 16c distill: 40 steps, loss mean of the first 10 "
        f"{mean(losses[:10]):.6e}, of the last 10 {mean(losses[-10:]):.6e}; "
        f"attack effect before {before:.6e}, after {after:.6e}")
    ok = {"distill losses finite": bool(np.isfinite(losses).all()),
          "distill loss falls": mean(losses[-10:]) < mean(losses[:10]),
          "distill attack effect falls": after < before}
    teacher = init_monodepth2(torch.Generator().manual_seed(2))
    cfg = HardeningConfig(
        selfsup=SelfSupConfig(height=H, width=W, frame_ids=("0", "s")),
        adv=AdvSynthConfig(norm_type="l_inf", steps=2, attack_batch_size=4,
                           epsilon=0.1, alpha=0.02, ori_h=OH, ori_w=OW),
        batch_size=4, learning_rate=3e-4, compute_dtype="float32")
    trainer = HardeningTrainer(cfg, torch.Generator().manual_seed(3), obj,
                               mask, predictor_from(teacher.to(dev)),
                               device=dev, steps_per_epoch=1000,
                               init_state_dict=teacher.state_dict())
    state = trainer.make_state()
    left, right = make_stereo_pair(4, OH, OW, shift=10, seed=5)
    frames = {"0": tens(left), "s": tens(right)}
    side = torch.ones(4, dtype=torch.bool, device=dev)
    flip = torch.zeros(4, dtype=torch.bool, device=dev)
    scenes = tens(make_scene(4, OH, OW, seed=6))
    before = _attack_effect(trainer, state, eval_scene,
                            cfg.adv.attack_batch_size)
    selfsup, sup = [], []
    for step in range(50):
        state, m = trainer.train_step(
            state, frames, side, flip, scenes, trainer.draw(
                4, torch.Generator().manual_seed(1000 + step)))
        selfsup.append(float(m["selfsup_loss"]))
        sup.append(float(m["sup_loss"]))
    after = _attack_effect(trainer, state, eval_scene,
                           cfg.adv.attack_batch_size)
    log(f"converge 16c harden: 50 steps, self-supervised loss mean of the "
        f"first 10 {mean(selfsup[:10]):.6e}, of the last 10 "
        f"{mean(selfsup[-10:]):.6e}; supervised {mean(sup[:10]):.6e} -> "
        f"{mean(sup[-10:]):.6e}; attack effect before {before:.6e}, after "
        f"{after:.6e} (x{after / before:.4f})")
    ok.update({"harden losses finite": bool(np.isfinite(selfsup + sup).all()),
               "self-supervised loss falls":
                   mean(selfsup[-10:]) < mean(selfsup[:10]),
               "supervised loss falls": mean(sup[-10:]) < mean(sup[:10]),
               "attack effect grows < 10%": after < before * 1.1})
    bad = [k for k, v in ok.items() if not v]
    if bad:
        raise AssertionError(f"phase 16c failed: {bad}")


def phase_zoo_loader(dev) -> None:
    """16d: `models/zoo.load_pretrained` from a zip written here (the
    golden weights in the release layout, its md5 put in the table for the
    call, urllib's fetch made to raise) onto the card, against the same
    load on the CPU: disp0 on 2 scenes at 640x192 within EVAL_DISP_ATOL
    (phase 14d's rule)."""
    import urllib.request
    import zipfile

    from depthmodelhardening_tpu_torch.models import zoo

    _, sd = _golden_weights()
    name = "mono+stereo_640x192"
    fetch, entry = urllib.request.urlretrieve, zoo.DOWNLOAD_PATHS[name]

    def refuse(url, path):
        raise AssertionError(f"phase 16d tried to fetch {url}")

    with tempfile.TemporaryDirectory(prefix="dmh_zoo_") as root:
        folder = checkpoints.export_reference_pth(root, 0, sd, height=192,
                                                  width=640)
        models = os.path.join(root, "models")
        os.makedirs(models)
        path = os.path.join(models, f"{name}.zip")
        with zipfile.ZipFile(path, "w") as z:
            for n in ("encoder.pth", "depth.pth"):
                z.write(os.path.join(folder, n), n)
        zoo.DOWNLOAD_PATHS[name] = (entry[0], zoo._md5(path))
        urllib.request.urlretrieve = refuse
        try:
            model, meta = zoo.load_pretrained(name, models, device=dev)
            cpu_model, _ = zoo.load_pretrained(name, models, device="cpu")
        finally:
            urllib.request.urlretrieve = fetch
            zoo.DOWNLOAD_PATHS[name] = entry
    x = bilinear_resize(torch.from_numpy(make_scene(2, 375, 1242,
                                                    seed=SEED + 310)),
                        192, 640)
    with torch.no_grad():
        got = predictor_from(model)(x.to(dev)).cpu()
        want = predictor_from(cpu_model)(x)
    err = float((got - want).abs().max())
    log(f"zoo 16d: load_pretrained({name!r}) from a local zip onto "
        f"{next(model.parameters()).device} (metadata {json.dumps(meta)}): "
        f"disp0 at 640x192 on 2 scenes, card vs CPU max |difference| "
        f"{err:.3e} (max {EVAL_DISP_ATOL})")
    if not err <= EVAL_DISP_ATOL or not bool(torch.isfinite(got).all()):
        raise AssertionError("phase 16d: the zoo's model on the card is "
                             "not the CPU's")


def phase_parallel(dev, f) -> dict:
    """Phase 16; returns the launches of 16a's ranks and 16b's CLI run."""
    _, sd = _golden_weights()
    cal = calibrated_teacher(dev, sd)
    obj, mask = make_car_object(300, 200, seed=SEED)
    t0 = time.perf_counter()
    launches, dp = phase_dp_ranks(dev, cal, obj, mask, f.spread)
    log(f"[phase 16a: {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = _CliRuns()
    phase_dp_cli(runs, f, dev, dp)
    for k, v in runs.total.items():
        launches[k] += v
    log(f"[phase 16b: {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_converge_long(dev)
    log(f"[phase 16c: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    phase_zoo_loader(dev)
    log(f"[phase 16d: {time.perf_counter() - t0:.1f} s]")
    return launches


# -- phase 17 ----------------------------------------------------------------
# the classifier attack surface (attacks/classifier.py, classifier_auto.py)
# through a ResNet-18 classifier: the port's ResnetEncoder(18), a global
# average pool of its last features and a linear head to 10 classes
# (torchvision's ResNet-18 layout, AutoAttack's default n_classes), flax's
# initialisation from a seed with every BatchNorm's statistics calibrated
# on the batch and the head scaled and centred to logits of unit spread,
# eval mode, float32, 224x224, batch 16, on synthetic scenes; the labels
# are the model's own predictions
CLS_BATCH, CLS_HW, CLS_CLASSES = 16, 224, 10
CLS_EPS = 8 / 255
# what phase 17's budget cuts from JAX's defaults (the rest run at them)
CLS_CUTS = {
    "deepfool": dict(steps=20),
    "sparsefool": dict(steps=3, deepfool_steps=10),
    "onepixel": dict(steps=3, popsize=50),
    "apgd": dict(steps=50),
    "apgdt": dict(steps=10),
    "fab": dict(steps=5),
    "square": dict(n_queries=150),
    "autoattack": dict(steps=20, square_queries=300),
}
# 17b: the card against the CPU at batch 2: a value differs when by more
# than CLS_SAME (float32 rounding of a step); FGSM's one signed step may
# split (a gradient near 0, where rounding decides its sign) on at most
# CLS_SPLIT_ONE of the values (4.35e-4 read on an NVIDIA H100 80GB HBM3
# at 700 W); DeepFool's two continuous steps stay within CLS_SAME_DF. The
# input gradients are held to CLS_GRAD_L2 relative L2 (the distillation
# rule's overall bound, tests/test_torch_distill.py): value by value they
# part by 2.5e-2 of their max where rounding flips a ReLU gate or a pool
# window's maximum of the calibrated random network (read on that card)
CLS_SAME, CLS_SPLIT_ONE, CLS_SAME_DF = 1e-5, 1e-3, 1e-4
CLS_GRAD_L2 = 1e-2


class CountingClassifier(torch.nn.Module):
    """The ResNet-18 classifier (B, 3, H, W) in [0, 1] -> (B, 10); on the
    card it counts its forwards and the backward passes that reach its
    input (each pools once forward, kernel B1, and once backward, B2)."""

    def __init__(self):
        super().__init__()
        self.encoder = ResnetEncoder(18)
        self.head = torch.nn.Linear(512, CLS_CLASSES)
        self.forwards = self.input_grads = 0

    def _count_grad(self, g):
        self.input_grads += 1

    def forward(self, x):
        if x.is_cuda:
            self.forwards += 1
            if x.requires_grad:
                x.register_hook(self._count_grad)
        return self.head(self.encoder(x)[-1].mean(dim=(2, 3)))


def _classifier_images(n, seed):
    return bilinear_resize(torch.from_numpy(make_scene(
        n, 375, 1242, seed=seed)), CLS_HW, CLS_HW).permute(0, 3, 1, 2)


def classifier(dev, images):
    """The seeded classifier on `dev`, its BatchNorm statistics those of
    `images` (a cumulative average over that one batch), its head scaled
    so that the eval logits of `images` have a standard deviation of 1
    (a random head on calibrated features saturates the softmax, whose
    gradients then vanish) and centred on each class's mean over them
    (else similar scenes all take one class), in eval mode."""
    model = flax_init_(CountingClassifier(),
                       torch.Generator().manual_seed(SEED + 170)).to(dev)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    with torch.no_grad():
        model.train()(images.to(dev))
        logits = model.eval()(images.to(dev))
        scale = logits.std()
        model.head.weight /= scale
        model.head.bias -= logits.mean(dim=0) / scale
    model.forwards = model.input_grads = 0
    return model


def _cls_suite(B, n_targets):
    """(name, run(model, x, y, generator) -> adv, constraint (norm,
    bound), targeted, predicted (forwards, input gradients) or None where
    the count depends on the data) for every attack of modules 1-2, at
    JAX's defaults but CLS_CUTS."""
    c, a = classifier_attacks, classifier_auto
    E = CLS_EPS
    sq, op = CLS_CUTS["square"], CLS_CUTS["onepixel"]
    n_pop = c._onepixel_population(3, 1, op["popsize"])[0]
    op_fwd = (op["steps"] + 1) * -(-B * n_pop // c.ONEPIXEL_CHUNK)
    tgt = lambda y: (y + 1) % CLS_CLASSES
    at, fb = CLS_CUTS["apgdt"]["steps"], CLS_CUTS["fab"]["steps"]
    ap = CLS_CUTS["apgd"]["steps"]
    return [
        ("fgsm", lambda m, x, y, g: c.fgsm(m, x, y), ("Linf", E), False,
         (1, 1)),
        ("bim", lambda m, x, y, g: c.bim(m, x, y), ("Linf", E), False,
         (10, 10)),
        ("rfgsm", lambda m, x, y, g: c.rfgsm(m, x, y, generator=g),
         ("Linf", E), False, (10, 10)),
        ("pgd", lambda m, x, y, g: c.pgd(m, x, y, generator=g), ("Linf", E),
         False, (10, 10)),
        ("pgd targeted", lambda m, x, y, g: c.pgd(
            m, x, tgt(y), generator=g, targeted=True), ("Linf", E), True,
         (10, 10)),
        ("pgdl2", lambda m, x, y, g: c.pgdl2(m, x, y, generator=g),
         ("L2", 1.0), False, (10, 10)),
        ("eotpgd", lambda m, x, y, g: c.eotpgd(m, x, y, generator=g),
         ("Linf", E), False, (20, 20)),
        ("ffgsm", lambda m, x, y, g: c.ffgsm(m, x, y, generator=g),
         ("Linf", E), False, (1, 1)),
        ("tpgd", lambda m, x, y, g: c.tpgd(m, x, generator=g), ("Linf", E),
         False, (11, 10)),
        ("mifgsm", lambda m, x, y, g: c.mifgsm(m, x, y), ("Linf", E), False,
         (10, 10)),
        ("gn", lambda m, x, y, g: c.gn(x, generator=g), ("box", None), None,
         (0, 0)),
        ("vanila", lambda m, x, y, g: c.vanila(x), ("Linf", 0.0), None,
         (0, 0)),
        ("cw", lambda m, x, y, g: c.cw(m, x, y), ("box", None), False,
         (51, 50)),
        ("cw targeted", lambda m, x, y, g: c.cw(m, x, tgt(y), targeted=True),
         ("box", None), True, (51, 50)),
        ("deepfool", lambda m, x, y, g: c.deepfool(
            m, x, y, **CLS_CUTS["deepfool"]), ("box", None), False, None),
        ("difgsm", lambda m, x, y, g: c.difgsm(m, x, y, generator=g),
         ("Linf", E), False, (10, 10)),
        ("jitter", lambda m, x, y, g: c.jitter(m, x, y, generator=g),
         ("Linf", E), False, (10, 10)),
        ("upgd", lambda m, x, y, g: c.upgd(m, x, y, generator=g),
         ("Linf", E), False, (10, 10)),
        ("tifgsm", lambda m, x, y, g: c.tifgsm(m, x, y, generator=g),
         ("Linf", E), False, (20, 20)),
        ("sparsefool", lambda m, x, y, g: c.sparsefool(
            m, x, y, **CLS_CUTS["sparsefool"]), ("box", None), False, None),
        ("onepixel", lambda m, x, y, g: c.onepixel(m, x, y, generator=g,
                                                   **op), ("L0", 1), False,
         (op_fwd, 0)),
        ("apgd", lambda m, x, y, g: a.apgd(m, x, y, generator=g, steps=ap),
         ("Linf", E), False, (ap + 1, ap + 1)),
        ("apgd L2", lambda m, x, y, g: a.apgd(m, x, y, norm="L2", eps=1.0,
                                              generator=g, steps=ap),
         ("L2", 1.0), False, (ap + 1, ap + 1)),
        ("apgdt", lambda m, x, y, g: a.apgdt(m, x, y, generator=g, steps=at),
         ("Linf", E), False,
         (1 + n_targets * (at + 1), n_targets * (at + 1))),
        ("fab", lambda m, x, y, g: a.fab(m, x, y, generator=g, steps=fb),
         ("Linf", 0.3), False, (2 * fb + 3, CLS_CLASSES * fb)),
        ("square", lambda m, x, y, g: a.square(m, x, y, generator=g, **sq),
         ("Linf", E), False, (sq["n_queries"] + 1, 0)),
        ("square L2", lambda m, x, y, g: a.square(
            m, x, y, norm="L2", eps=1.0, generator=g, **sq), ("L2", 1.0),
         False, (sq["n_queries"] + 1, 0)),
        ("multiattack", lambda m, x, y, g: a.multiattack(
            [lambda xx, yy: c.fgsm(m, xx, yy, eps=1 / 255),
             lambda xx, yy: c.pgd(m, xx, yy, generator=g)], m, x, y),
         ("Linf", E), False, None),
        ("autoattack", lambda m, x, y, g: a.autoattack(
            m, x, y, **CLS_CUTS["autoattack"]), ("Linf", E), False, None),
    ]


def _constraint(adv, x, norm, eps):
    """(the perturbation's size under `norm`, whether it holds)."""
    d = (adv - x).flatten(1)
    if norm == "Linf":
        size = float(d.abs().max())
        return size, size <= eps + 1e-6
    if norm == "L2":
        size = float(d.norm(dim=1).max())
        return size, size <= eps + 1e-4
    if norm == "L0":
        size = int(((adv - x).abs() > 0).any(dim=1).flatten(1).sum(1).max())
        return size, size <= eps
    return float(d.abs().max()), True  # [0, 1] only: the L-inf size


def _goal_prob(model, x, y):
    with torch.no_grad():
        return torch.softmax(model(x), 1).gather(1, y[:, None]).mean().item()


def phase_classifier_attacks(dev, model, x, y) -> dict:
    """17a: every attack once at 224x224, batch 16: seconds (synchronised),
    its constraint against its bound, accuracy before and after, the mean
    probability of the label (targeted: of the target, label + 1), its
    forwards and input gradients against the predicted ones. Fails on a
    broken constraint, a non-finite output, an untargeted attack that
    raises accuracy or a targeted one that lowers its target's
    probability."""
    log(f"classifier 17a: a ResNet-18 classifier (the port's "
        f"ResnetEncoder(18), global average pool, Linear(512, "
        f"{CLS_CLASSES})), flax's seeded init, BatchNorm calibrated on the "
        f"batch, eval, float32, {CLS_HW}x{CLS_HW}, batch {CLS_BATCH}, "
        f"labels its own predictions; JAX's defaults but these cuts: "
        f"{json.dumps(CLS_CUTS)}")
    with torch.no_grad():
        acc0 = float((model(x).argmax(1) == y).float().mean())
    for i, (name, run, (norm, eps), targeted, want) in enumerate(
            _cls_suite(CLS_BATCH, CLS_CLASSES - 1)):
        goal = (y + 1) % CLS_CLASSES if targeted else y
        p0 = _goal_prob(model, x, goal)
        before = (model.forwards, model.input_grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adv = run(model, x, y, torch.Generator().manual_seed(SEED + 300 + i))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counted = (model.forwards - before[0], model.input_grads - before[1])
        size, held = _constraint(adv, x, norm, eps)
        with torch.no_grad():
            acc = float((model(adv).argmax(1) == y).float().mean())
        p1 = _goal_prob(model, adv, goal)
        finite = bool(torch.isfinite(adv).all()) and \
            0.0 <= float(adv.min()) and float(adv.max()) <= 1.0
        log(f"  {name}: {secs:.4f} s; {norm} {size:.6g} (bound {eps}); "
            f"accuracy {acc0:.4f} -> {acc:.4f}; mean p("
            f"{'target' if targeted else 'label'}) {p0:.6f} -> {p1:.6f}; "
            f"forwards {counted[0]}, input gradients {counted[1]}"
            + (f" (predicted {want[0]}, {want[1]})" if want else
               " (data-dependent)"))
        if not (held and finite):
            raise AssertionError(f"classifier {name}: constraint {held}, "
                                 f"finite in [0, 1] {finite}")
        if (targeted is False and acc > acc0) or \
                (targeted and p1 < p0):
            raise AssertionError(f"classifier {name}: the attack moved "
                                 f"away from its goal")
        if want is not None and counted != want:
            raise AssertionError(f"classifier {name}: {counted} model "
                                 f"passes, predicted {want}")
        if name == "pgd":  # phase 18's pair: the same call again
            again = run(model, x, y, torch.Generator().manual_seed(
                SEED + 300 + i))
            record_repeat("17a PGD", outcome(adv=adv), outcome(adv=again))


def phase_classifier_parity(dev, model, x, y) -> None:
    """17b: the card against the CPU's plain versions at batch 2: FGSM,
    BIM (3 steps), PGD from an injected start, MIFGSM, CW (3 steps),
    DeepFool (2 steps), APGD (5 steps, injected start). The input
    gradient at the images and at PGD's start within CLS_GRAD_L2
    relative L2; FGSM's one signed step
    split on at most CLS_SPLIT_ONE of the values, the rest within
    CLS_SAME; DeepFool's two continuous steps within CLS_SAME_DF; the
    multi-step sign attacks and CW, whose first splits spread through
    ResNet-18's receptive field (it covers the image) and cannot be held
    value by value: their share apart logged, and the card's adversarial
    images predicted as the CPU's."""
    c, a = classifier_attacks, classifier_auto
    cpu = CountingClassifier()
    cpu.load_state_dict(model.state_dict())
    cpu.eval()
    xs, ys = x[:2].cpu(), y[:2].cpu()
    gen = torch.Generator().manual_seed(SEED + 350)
    start = c.uniform_start(gen, xs, CLS_EPS)
    t_apgd = [a.apgd_draws(gen, xs, "Linf")]
    for at, what in ((xs, "the images"),
                     (torch.clamp(xs + start.noise, 0.0, 1.0), "PGD's start")):
        g = {d: c._loss_grad(m, at.to(d), ys.to(d), False).cpu()
             for d, m in ((dev, model), ("cpu", cpu))}
        l2 = float((g[dev] - g["cpu"]).norm() / g["cpu"].norm())
        err = float((g[dev] - g["cpu"]).abs().max() / g["cpu"].abs().max())
        log(f"classifier 17b: input gradient at {what}, card vs CPU: "
            f"{l2:.3e} relative L2 (max {CLS_GRAD_L2}), its largest "
            f"difference {err:.3e} of its max")
        if not l2 <= CLS_GRAD_L2:
            raise AssertionError(f"classifier: the gradient at {what} "
                                 f"parts")
    runs = (("fgsm", lambda m, x_, y_: c.fgsm(m, x_, y_)),
            ("bim", lambda m, x_, y_: c.bim(m, x_, y_, steps=3)),
            ("pgd", lambda m, x_, y_: c.pgd(m, x_, y_, steps=3, draws=start)),
            ("mifgsm", lambda m, x_, y_: c.mifgsm(m, x_, y_, steps=3)),
            ("cw", lambda m, x_, y_: c.cw(m, x_, y_, steps=3)),
            ("deepfool", lambda m, x_, y_: c.deepfool(m, x_, y_, steps=2)),
            ("apgd", lambda m, x_, y_: a.apgd(m, x_, y_, steps=5,
                                             draws=t_apgd)))
    for name, run in runs:
        got = run(model, xs.to(dev), ys.to(dev)).cpu()
        want = run(cpu, xs, ys)
        d = (got - want).abs()
        split = float((d > CLS_SAME).float().mean())
        with torch.no_grad():
            same_pred = torch.equal(cpu(got).argmax(1), cpu(want).argmax(1))
        log(f"classifier 17b {name}: card vs CPU at batch 2: {split:.4%} of "
            f"the values apart by more than {CLS_SAME}, max |difference| "
            f"{float(d.max()):.3e}; the same predictions {same_pred}")
        held = {"fgsm": split <= CLS_SPLIT_ONE,
                "deepfool": float(d.max()) <= CLS_SAME_DF}.get(name,
                                                                same_pred)
        if not held:
            raise AssertionError(f"classifier {name}: the card and the CPU "
                                 f"part")


def phase_classifier_pool(dev, passes, launches) -> None:
    """17c: kernel B's launches over 17a-17b against the model passes,
    then B at the classifier's stem shape against its plain version,
    forward and backward (bit for bit), timed beside the library's."""
    b1, b2 = launches["maxpool3x3s2_fwd"], launches["maxpool3x3s2_bwd"]
    log(f"classifier 17c: B1 {b1}, B2 {b2} launches over 17a-17b; the "
        f"classifier's forwards {passes[0]}, input gradients {passes[1]}")
    if (b1, b2) != passes:
        raise AssertionError("classifier: B's launches are not the model's "
                             "passes")
    if others := {k: v for k, v in launches.items()
                  if v and not k.startswith("maxpool3x3s2_")}:
        raise AssertionError(f"classifier: unexpected launches {others}")
    gen = torch.Generator().manual_seed(SEED + 360)
    shape = (CLS_BATCH, 64, CLS_HW // 2, CLS_HW // 2)
    x = torch.relu(torch.randn(shape, generator=gen)).to(dev)
    y_k = pool.maxpool3x3s2_fwd_cuda(x)
    y_p = pool.maxpool3x3s2_plain(x)
    g = torch.randn(y_p.shape, generator=gen).to(dev)
    dx_k = pool.maxpool3x3s2_bwd_cuda(x, g)
    dx_p = pool.maxpool3x3s2_backward_plain(x, g)
    exact = torch.equal(y_k, y_p) and torch.equal(dx_k, dx_p)
    _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
    fwd = (cuda_ms(lambda: pool.maxpool3x3s2_fwd_cuda(x)),
           cuda_ms(lambda: pool.maxpool3x3s2_plain(x)),
           cuda_ms(lambda: F.max_pool2d(x, 3, 2, 1)),
           bound(nbytes(x, y_k), 8 * y_k.numel()))
    bwd = (cuda_ms(lambda: pool.maxpool3x3s2_bwd_cuda(x, g)),
           cuda_ms(lambda: pool.maxpool3x3s2_backward_plain(x, g)),
           cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
               g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)),
           bound(nbytes(x, g, dx_k), 26 * g.numel()))
    for name, (ms, plain, lib, (b, by)) in (("B1", fwd), ("B2", bwd)):
        log(f"  {name} at {shape}: bit-exact {exact}; {ms:.4f} ms on the "
            f"card alone, plain {plain:.4f}, library {lib:.4f}, bound "
            f"{b:.4f} ({by}): {b / ms:.0%} of it")
    if not exact:
        raise AssertionError("pool kernel is not bit-exact at the "
                             "classifier's stem")


def phase_options_manydepth(dev) -> dict:
    """17d: ManyDepth's evaluation forward in 14d's setting (a weights
    folder, then `ManyDepthModel` at 640x192, batch 12 on the card, a
    lookup 4 columns over, a 0.1 x-translation; seeded weights) with
    inverse binning (the folder's metadata) and then with missing bins
    left at 0: single-frame and multi-frame, card against CPU on 2 items
    within 14d's EVAL_DISP_ATOL, lowest_cost and confidence within
    EVAL_SPLIT_MAX of their pixels; B once and D 4 times a forward."""
    e = MANYDEPTH_EVAL
    H, W, B = e["height"], e["width"], e["batch"]
    seeded = flax_init_(ManyDepthModel(input_height=H, input_width=W),
                        torch.Generator().manual_seed(SEED + 380))
    root = os.path.join(REPO, "build", "manydepth_options_smoke")
    shutil.rmtree(root, ignore_errors=True)
    folder = checkpoints.export_manydepth_reference(
        root, 0, seeded.state_dict(), height=H, width=W,
        min_depth_bin=e["min_depth_bin"], max_depth_bin=e["max_depth_bin"])
    path = os.path.join(folder, "encoder.pth")
    torch.save(dict(torch.load(path, weights_only=True),
                    depth_binning="inverse"), path)
    cpu_model, meta = checkpoints.load_manydepth_reference(folder,
                                                           device="cpu")
    model, _ = checkpoints.load_manydepth_reference(folder, device=dev)
    shutil.rmtree(root, ignore_errors=True)
    x = bilinear_resize(torch.from_numpy(make_scene(B, 375, 1242,
                                                    seed=SEED + 381)), H, W)
    look = torch.roll(x, 4, dims=2)[:, None]
    pose = torch.eye(4).repeat(B, 1, 1)
    pose[:, 0, 3] = 0.1
    K, invK = quarter_intrinsics(MONODEPTH2_K, H, W)
    kw = lambda d, n: dict(K=K.expand(n, 4, 4).to(d),
                           invK=invK.expand(n, 4, 4).to(d),
                           min_depth_bin=meta["min_depth_bin"],
                           max_depth_bin=meta["max_depth_bin"])
    runs = {"single": lambda m, d, n: (m(x[:n].to(d), **kw(d, n)),),
            "multi": lambda m, d, n: m.multi_frame(
                x[:n].to(d), look[:n].to(d), pose[:n, None].to(d),
                **kw(d, n))}
    total = {k.name: 0 for k in _build.KERNELS}
    for option in ("inverse bins", "missing bins at 0"):
        if option == "missing bins at 0":
            for m in (model, cpu_model):
                m.encoder.set_missing_to_max = False
        for mode, run in runs.items():
            with torch.no_grad():
                want = run(cpu_model, torch.device("cpu"), 2)
                got = [t.cpu() for t in run(model, dev, 2)]
                torch.cuda.synchronize()
                _build.reset_launches()
                full = run(model, dev, B)
                torch.cuda.synchronize()
            launches = {k.name: k.launches for k in _build.KERNELS}
            err = float((got[0] - want[0]).abs().max())
            splits = [float((g != w).float().mean())
                      for g, w in zip(got[1:], want[1:])]
            log(f"options 17d ManyDepth ({option}, metadata depth_binning "
                f"{meta.get('depth_binning')!r}) {mode} at {W}x{H}: card vs "
                f"CPU on 2 items: disp0 max |difference| {err:.3e} (max "
                f"{EVAL_DISP_ATOL}), lowest_cost and confidence differ on "
                f"{json.dumps(splits)} (max {EVAL_SPLIT_MAX}); batch {B} "
                f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
            _expect_launches(f"17d {option} {mode}", launches,
                             {"maxpool3x3s2_fwd": 1, "conv3x3_fwd": 4})
            if not err <= EVAL_DISP_ATOL or not all(
                    s <= EVAL_SPLIT_MAX for s in splits) or not all(
                    bool(torch.isfinite(t).all()) for t in full):
                raise AssertionError(f"ManyDepth with {option} failed")
            for k, v in launches.items():
                total[k] += v
    return total


L2_EPS = 8.0


def phase_options_zoo(dev) -> dict:
    """17d: one batch of the object APGD under the L2 norm (the apgd
    preset's steps and batch, eps 8 over the 300x200 car's texture as
    the l2_eps8 preset's, n_restarts 2: the first run's result) and one of whole-image PGD
    untargeted (the image preset), at full width through evaluate_attacks:
    constraints held, finite metrics, launches against `zoo_launches`
    (untargeted: one more forward, the clean prediction)."""
    _, sd = _golden_weights()
    predictor = _golden_predictor(dev, sd)
    obj, mask = make_car_object(300, 200, seed=SEED)
    total = {k.name: 0 for k in _build.KERNELS}
    image_preset = next(n for n, p in EVAL_PRESETS.items()
                        if p.norm_type == "image")
    for i, (name, label) in enumerate((("apgd_eps005", "APGD L2"),
                                       (image_preset, "image untargeted"))):
        cfg = _preset_cfg(name, EVAL_PRESETS[name])
        attack = build_attack(cfg, predictor, obj, mask)
        if cfg.norm_type == "APGD":
            attack = _KeptCalls(APGDObjectAttack(
                predictor, obj, mask, attack.cfg, norm="L2", eps=L2_EPS,
                steps=cfg.step, n_restarts=2))
        else:
            attack = _KeptCalls(PGDImageAttack(
                predictor, eps=cfg.epsilon, alpha=cfg.alpha, steps=cfg.step,
                targeted=False, scene_hw=(cfg.scene_h, cfg.scene_w)))
        scenes = make_scene(cfg.batch_size, cfg.ori_h, cfg.ori_w,
                            seed=SEED + 390 + i)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = evaluate_attacks(predictor, attack, [scenes], cfg,
                               generator=torch.Generator().manual_seed(
                                   SEED + 395 + i))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _build.KERNELS}
        want = zoo_launches(cfg)
        if cfg.norm_type == "image":
            want["maxpool3x3s2_fwd"] += 1
            want["conv3x3_fwd"] += 4
            adv, ben = attack.outputs[-1]
            size = float((adv - ben).abs().max())
            if not size <= cfg.epsilon + 1e-6:
                raise AssertionError(f"17d {label}: L-inf {size}")
            size = f"L-inf {size:.6g} (bound {cfg.epsilon})"
        else:
            size = float((attack.outputs[-1][3] - attack.attack.obj_img)
                         .norm())
            if not size <= L2_EPS + 1e-4:
                raise AssertionError(f"17d {label}: L2 {size} > {L2_EPS}")
            size = f"L2 {size:.6f} (bound {L2_EPS})"
        log(f"options 17d {label} ({name}, batch {cfg.batch_size}, "
            f"{cfg.step} steps): {secs:.4f} s/batch; {size}; metrics mean "
            f"{json.dumps({k: round(v, 6) for k, v in res['mean'].items()})};"
            f" launches {json.dumps({k: v for k, v in launches.items() if v})}")
        _expect_launches(f"17d {label}", launches, want)
        if not all(math.isfinite(v) for v in res["mean"].values()):
            raise AssertionError(f"17d {label}: non-finite metrics")
        for k, v in launches.items():
            total[k] += v
    return total


def phase_options_hints(dev) -> dict:
    """17d: one DepthHints step in 14a's configuration (ResNet-50,
    contras_loss_wt 0.1, the CLI's bf16 student) with use_depth_hints
    False, which takes the self-supervised loss (as in JAX); then the
    DepthHints loss itself with use_depth_hints=False on a stereo batch
    at 1024x320 (batch 2, no hint planes), forward and backward on the
    card against the CPU's: the loss within 1e-4 relative, C launched 5
    times forward (4 scales and the identity) and 4 + 4 backward."""
    from depthmodelhardening_tpu_torch.training import depth_hints

    family = dict(FAMILY_RUNS[0][1], use_depth_hints=False)
    cfg = dataclasses.replace(_cli_cfg(("0", "s")), **family)
    sd, _, _ = calibrated_family(dev, cfg, SEED + 130)
    obj, mask = make_car_object(300, 200, seed=SEED)
    trainer = _harden_trainer(dev, cfg, sd, obj, mask, SEED + 134)
    inputs = _harden_inputs(dev, cfg, SEED + 135)
    _, launches = run_hardening_steps("17d hints off", trainer, inputs, 1,
                                      repeat=False)
    del trainer, inputs
    torch.cuda.empty_cache()
    H, W, B = 320, 1024, 2
    f0 = bilinear_resize(torch.from_numpy(make_scene(B, 375, 1242,
                                                     seed=SEED + 398)), H, W)
    K, invK = hint_data.scaled_K(H, W)
    batch = {"color": {"0": f0, "s": torch.roll(f0, 4, dims=2)},
             "K": torch.from_numpy(K).expand(B, 4, 4),
             "inv_K": torch.from_numpy(invK.astype(np.float32)).expand(
                 B, 4, 4),
             "stereo_T": stereo_T_batch(torch.tensor([True, False]),
                                        torch.tensor([False, True]))}
    gen = torch.Generator().manual_seed(SEED + 399)
    disps = {s: 0.2 + 0.4 * torch.rand(B, H >> s, W >> s, 1, generator=gen)
             for s in range(4)}
    ss = SelfSupConfig(height=H, width=W)
    noise = torch.randn(depth_hints.identity_noise_shape(ss, B),
                        generator=gen)

    def loss_and_grad(d):
        on = lambda t: t.to(d)
        ds = {s: v.detach().to(d).requires_grad_(True)
              for s, v in disps.items()}
        b = {"color": {k: on(v) for k, v in batch["color"].items()},
             **{k: on(batch[k]) for k in ("K", "inv_K", "stereo_T")}}
        loss, _ = depth_hints.compute_depth_hints_losses(
            ds, b, {}, on(noise), ss, use_depth_hints=False)
        loss.backward()
        return loss.item(), [ds[s].grad.cpu() for s in range(4)]

    want, g_cpu = loss_and_grad(torch.device("cpu"))
    torch.cuda.synchronize()
    _build.reset_launches()
    got, g_card = loss_and_grad(dev)
    torch.cuda.synchronize()
    direct = {k.name: k.launches for k in _build.KERNELS}
    grad = max(float((a - b).norm() / b.norm()) for a, b in zip(g_card,
                                                                g_cpu))
    log(f"options 17d: compute_depth_hints_losses(use_depth_hints=False) at "
        f"{W}x{H}, batch 2: card {got:.7f}, CPU {want:.7f} ({_rel(got, want):.2e}"
        f" relative), the disparities' gradients within {grad:.2e} relative "
        f"L2; launches {json.dumps({k: v for k, v in direct.items() if v})}")
    _expect_launches("17d hint-free loss", direct, {
        "reproj_loss_fwd": 5, "reproj_loss_bwd_q": 4,
        "reproj_loss_bwd_grad": 4})
    if not _rel(got, want) <= 1e-4 or not grad <= 1e-3 or \
            not math.isfinite(got):
        raise AssertionError("the hint-free DepthHints loss parts from the "
                             "CPU's")
    for k, v in direct.items():
        launches[k] += v
    return launches


def phase_classifier(dev) -> dict:
    """Phase 17; returns its launches (17a-17b's B, 17d's)."""
    t_start = time.perf_counter()
    x = _classifier_images(CLS_BATCH, SEED + 310).to(dev)
    model = classifier(dev, x)
    with torch.no_grad():
        y = model(x).argmax(1)
    log(f"classifier: own labels of the {CLS_BATCH} images: "
        f"{y.tolist()}")
    torch.cuda.synchronize()
    _build.reset_launches()
    model.forwards = model.input_grads = 0
    t0 = time.perf_counter()
    phase_classifier_attacks(dev, model, x, y)
    log(f"  [17a: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    phase_classifier_parity(dev, model, x, y)
    log(f"  [17b: {time.perf_counter() - t0:.1f} s]")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS}
    passes = (model.forwards, model.input_grads)
    t0 = time.perf_counter()
    phase_classifier_pool(dev, passes, launches)
    log(f"  [17c: {time.perf_counter() - t0:.1f} s]")
    del model, x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for part in (phase_options_manydepth, phase_options_zoo,
                 phase_options_hints):
        for k, v in part(dev).items():
            launches[k] += v
        torch.cuda.empty_cache()
    log(f"  [17d: {time.perf_counter() - t0:.1f} s]")
    log(f"  [phase 17 in all: {time.perf_counter() - t_start:.1f} s]")
    return launches


# -- phase 18 ----------------------------------------------------------------
# The paths that must give the same bits twice in one process. Each runs
# twice where its phase drives it (`repeat_twice`), from the same weights
# and inputs, its generators seeded afresh before each run: in phases 5
# and 8-14 the pair is the path's warm-up (the timed steps go on from the
# second run's state), 13b's presets and 17a's PGD run once more, and
# 15a's are phase 15's two direct steps of the CLI's first one. Phase 18
# holds the two runs of each bit for bit: losses, metrics, the gradient
# of every tensor, the updated parameters, the BatchNorm statistics,
# textures, adversarial images and L0 iteration counts.
REPEAT_PATHS = {
    "5": "the L-inf PGD-10 attack batch",
    "8": "the self-supervised step",
    "9": "the float32 distillation step",
    "10": "bench.py's bf16 distillation step",
    "11": "the float32 hardening step",
    "12a": "the CLI's bf16 hardening step, frames 0,s",
    "12b": "the CLI's bf16 hardening step, mono+stereo",
    "13b image": "the image_eps001 preset's batch",
    "13b l0": "the l0_thresh01 preset's batch",
    "14a": "DepthHints on ResNet-50, bf16 step",
    "14b": "ManyDepth, bf16 step",
    "14c": "ManyDepth with the real lookup, bf16 step",
    "15a": "the CLI's first train-hardening --fine-tune step from files "
           "(two direct train_steps of it)",
    "17a PGD": "PGD on the ResNet-18 classifier",
}
REPEATED = {}


def outcome(modules=None, metrics=None, **extra) -> dict:
    """What one run gave, each tensor cloned by name: its metrics (loss
    terms or attack metrics), each module's parameters, their gradients
    and its buffers (the BatchNorm statistics), and `extra` (textures,
    adversarial images, L0 iterations)."""
    out = {f"metric {k}": torch.as_tensor(v).detach().reshape(1).clone()
           for k, v in (metrics or {}).items()}
    for key, m in (modules or {}).items():
        for n, p in m.named_parameters():
            out[f"{key}.{n}"] = p.detach().clone()
            if p.grad is not None:
                out[f"{key}.{n} grad"] = p.grad.detach().clone()
        for n, b in m.named_buffers():
            out[f"{key}.{n}"] = b.detach().clone()
    for k, v in extra.items():
        out[k] = torch.as_tensor(v).detach().clone()
    return out


def _state_modules(state) -> dict:
    return (state.modules() if hasattr(state, "modules")
            else {"model": state.model})


def repeat_distance(a: dict, b: dict) -> dict:
    """Of two runs' outcomes: the tensors in all, and those that differ
    with their relative L2 distance."""
    differ = {}
    for k in a:
        if not torch.equal(a[k], b[k]):
            x, y = a[k].double(), b[k].double()
            differ[k] = float((x - y).norm() / y.norm().clamp_min(1e-300))
    return {"tensors": len(a), "differ": differ}


def record_repeat(path, a: dict, b: dict) -> None:
    REPEATED[path] = rec = repeat_distance(a, b)
    worst = sorted(rec["differ"].items(), key=lambda kv: -kv[1])[:4]
    log(f"  repeat {path}: two runs " + (
        f"bit-equal in all {rec['tensors']} tensors" if not worst else
        f"differ in {len(rec['differ'])} of {rec['tensors']} tensors, the "
        f"largest relative L2 {json.dumps(worst)}"))


def repeat_twice(path, run):
    """run() -> (outcome, kept), twice; records the two outcomes'
    distance under `path` and returns the second run's kept value."""
    a, _ = run()
    b, kept = run()
    record_repeat(path, a, b)
    return kept


def _reseed(trainer, seed) -> None:
    """The trainer's generators seeded afresh: the same draws each run."""
    trainer.generator.manual_seed(seed)
    if hasattr(trainer, "noise_generator"):
        trainer.noise_generator.manual_seed(seed + 1)


@contextlib.contextmanager
def _keeping(obj, name, kept):
    """obj.name's results appended to `kept` while active (an instance
    attribute over the class's method)."""
    orig = getattr(obj, name)

    def call(*a, **k):
        kept.append(orig(*a, **k))
        return kept[-1]

    setattr(obj, name, call)
    try:
        yield kept
    finally:
        delattr(obj, name)


def hardening_run(trainer, inputs, seed, seen=None):
    """One `train_step` of `trainer` on inputs (frames, sides, flips,
    scene) from a fresh state, its generators seeded with `seed`, its
    metrics handed to `seen`: (its outcome with the texture and the L0
    iterations, the state)."""
    _reseed(trainer, seed)
    with _keeping(trainer, "refresh_texture", []) as tex:
        state, m = trainer.train_step(trainer.make_state(), *inputs)
    if seen is not None:
        seen(m)
    return outcome(_state_modules(state), m, texture=tex[0], l0_iterations=[
        trainer.attack.last_iterations]), state


class _KeptCalls:
    """An attack whose outputs are kept (evaluate_attacks only calls it)."""

    def __init__(self, attack):
        self.attack, self.outputs = attack, []

    def __call__(self, *a, **k):
        self.outputs.append(self.attack(*a, **k))
        return self.outputs[-1]


def eval_run(predictor, attack, scenes, cfg, seed):
    """One evaluate_attacks batch of `scenes`, its generator seeded with
    `seed`: (its outcome: the 8 mean metrics, the attack's outputs (the
    adversarial images, and an object attack's masks and texture) and the
    L0 iterations; evaluate_attacks' result)."""
    kept = _KeptCalls(attack)
    res = evaluate_attacks(predictor, kept, [scenes],
                           dataclasses.replace(cfg, eval_count=1),
                           generator=torch.Generator().manual_seed(seed))
    extra = {f"output {i}": t for i, t in enumerate(kept.outputs[0])}
    if hasattr(attack, "last_iterations"):
        extra["l0_iterations"] = [attack.last_iterations]
    return outcome(metrics=res["mean"], **extra), res


def phase_repeat() -> None:
    """Phase 18: each path of REPEAT_PATHS ran twice with the same bits."""
    log("repeat: each path twice in this process, from the same weights, "
        "inputs and freshly seeded generators:")
    bad = []
    for path, what in REPEAT_PATHS.items():
        rec = REPEATED.get(path)
        if rec is None:
            bad.append(f"{path} not run")
            log(f"  {path} ({what}): not run")
            continue
        worst = sorted(rec["differ"].items(), key=lambda kv: -kv[1])[:4]
        log(f"  {path} ({what}): " + (
            f"bit-equal, {rec['tensors']} tensors" if not worst else
            f"{len(rec['differ'])} of {rec['tensors']} tensors differ, the "
            f"largest relative L2 {json.dumps(worst)}"))
        if worst:
            bad.append(path)
    if bad:
        raise AssertionError(f"phase 18: these paths do not repeat: {bad}")


# -- phase 19 ----------------------------------------------------------------
ROUTE_LAYERS = (18, 50)  # the bf16 hardening cells' encoders
# the batches the cells run them at, with the gradients each computes: the
# L0 attack's (detached weights) and the student's
ROUTE_BATCHES = ((12, False), (32, True))


def route_shapes(dev) -> list:
    """Each distinct bf16 convolution of a hardening cell, as ("conv", x's
    (Cin, H, W), w's shape, stride, padding) for every `F.conv2d` that
    `conv_route` runs and ("D", (Cin, H, W), w's shape) for every layer of
    kernel D (its weight gradient is routed): recorded from one forward
    of the bf16 Monodepth2 student on ResNet-18 and ResNet-50 at 1024x320,
    batch 1."""
    seen = {}
    conv2d, reflect = F.conv2d, conv.conv3x3_reflect_cuda

    def conv2d_rec(x, w, bias=None, stride=1, padding=0, *a, **k):
        if x.dtype == torch.bfloat16:
            seen[("conv", tuple(x.shape[1:]), tuple(w.shape),
                  conv_route._pair(stride), conv_route._pair(padding))] = 1
        return conv2d(x, w, bias, stride, padding, *a, **k)

    def reflect_rec(x, w, *a, **k):
        seen[("D", tuple(x.shape[1:]), tuple(w.shape))] = 1
        return reflect(x, w, *a, **k)
    F.conv2d, conv.conv3x3_reflect_cuda = conv2d_rec, reflect_rec
    try:
        for layers in ROUTE_LAYERS:
            model = make_monodepth2(layers, dtype="bfloat16").to(dev)
            with torch.no_grad():
                model.features_and_disps(torch.rand(1, 320, 1024, 3,
                                                    device=dev))
            del model
    finally:
        F.conv2d, conv.conv3x3_reflect_cuda = conv2d, reflect
    return list(seen)


def _route_errors(got, want, terms: int) -> dict:
    """A bf16 result against the float32 one of the same operands: the
    elements beyond one bf16 ulp of that result rounded once plus
    CONV_RTOL of its largest magnitude (`check_conv`'s bf16 rule, set for
    float32 sums of up to 576 products), the same with that slack grown
    as a float32 sum's rounding grows, by sqrt(terms / 576), and the
    largest difference over the largest magnitude."""
    want = want.detach()
    r = want.to(torch.bfloat16).float()
    d = (got.float() - r).abs()
    ulp, top = bf16_ulp(r), float(want.abs().max())
    grown = CONV_RTOL * top * max(1.0, (terms / 576) ** 0.5)
    return {"over": int((d > ulp + CONV_RTOL * top).sum()),
            "over_grown": int((d > ulp + grown).sum()),
            "max_rel": float(d.max()) / max(top, 1e-30)}


def phase_conv_route(dev) -> dict:
    """Each routed bf16 convolution pass at the cells' shapes (batch 12
    with the input gradient, as the attack runs it; batch 32 with both
    gradients in one backward, as the student's step does) through
    `conv_route` against the float32 result of the same bf16 operands
    (cuDNN off, TF32 off), beside today's im2col path on the same inputs:
    the forward and the input gradient within `check_conv`'s bf16 rule on
    every element; the weight gradient (a float32 sum of N * H * W
    products, up to 2.6M) on no more elements beyond that rule than the
    im2col path's, and within the rule with its slack grown by sqrt(terms
    / 576) on every element. Kernel D's weight gradient the same, through
    `conv.weight_grad`. `conv_route.passes()` must count each pass on the
    backend `conv_route.route` gives it. Returns the routes' pass counts."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = route_shapes(dev)
    conv_route.reset_passes()
    want_passes = collections.Counter()
    worst = {}
    for key in shapes:
        kind, (cin, h, w_), wshape = key[:3]
        stride, pad = key[3:] if kind == "conv" else (1, 0)
        for B, student in ROUTE_BATCHES:
            x = torch.rand((B, cin, h, w_), generator=gen, device=dev)
            if kind == "D":
                x = reflect_pad1(x)
            wt = torch.randn(wshape, generator=gen, device=dev) / (
                wshape[1] * wshape[2] * wshape[3]) ** 0.5
            xb, wb = x.bfloat16(), wt.bfloat16()
            ho = (x.shape[2] + 2 * pad - wshape[2]) // stride + 1
            wo = (x.shape[3] + 2 * pad - wshape[3]) // stride + 1
            g = torch.randn((B, wshape[0], ho, wo), generator=gen,
                            device=dev).bfloat16()
            x32 = xb.float().requires_grad_(True)
            w32 = wb.float().requires_grad_(student)
            y32 = F.conv2d(x32, w32, None, stride, pad)
            want = [y32] + list(torch.autograd.grad(
                y32, [x32, w32] if student else [x32], g.float()))
            runs = {}
            for name in ("route", "im2col"):
                xr = xb.clone().requires_grad_(kind == "conv")
                wr = wb.clone().requires_grad_(student)
                if kind == "D":  # D's weight gradient alone
                    fn = conv.weight_grad if name == "route" else (
                        lambda a, b, c: torch.nn.grad.conv2d_weight(
                            a, b.shape, c))
                    runs[name] = [None, None, fn(xb, wb, g)] if student \
                        else None
                    continue
                fn = conv_route.conv2d if name == "route" else F.conv2d
                y = fn(xr, wr, None, stride, pad)
                y.backward(g)
                runs[name] = [y.detach(), xr.grad,
                              wr.grad if student else None]
            if kind == "D" and not student:
                continue
            n = B * ho * wo
            for i, p in enumerate(conv_route.PASSES):
                if runs["route"][i] is None:
                    continue
                terms = n if p == "wgrad" else (
                    wshape[1] * wshape[2] * wshape[3] if p == "fwd"
                    else wshape[0] * wshape[2] * wshape[3])
                ref = want[i] if kind == "conv" else want[2]
                e = _route_errors(runs["route"][i], ref, terms)
                e0 = _route_errors(runs["im2col"][i], ref, terms)
                ok = (e["over"] == 0 if p != "wgrad" else
                      e["over"] <= e0["over"] and e["over_grown"] == 0)
                label = f"{kind} B{B} {key[1]} {wshape} s{stride}p{pad} {p}"
                if not ok:
                    raise AssertionError(
                        f"conv route {label}: {e} (im2col {e0})")
                worst[p] = max(worst.get(p, 0.0), e["max_rel"])
                log(f"conv route {label}: {json.dumps(e)}; im2col "
                    f"{json.dumps(e0)}")
            k = (wshape[2], wshape[3])
            if kind == "conv":
                want_passes[conv_route.route(
                    torch.bfloat16, "fwd", k, stride, cin, wshape[0])
                    + ".fwd"] += 1
                grads = ("dgrad", "wgrad") if student else ("dgrad",)
                node = ("cudnn" if all(conv_route.route(
                    torch.bfloat16, q, k, stride, cin, wshape[0]) == "cudnn"
                    for q in grads) else "im2col")
                for q in grads:
                    want_passes[f"{node}.{q}"] += 1
            else:
                want_passes[conv_route.route(
                    torch.bfloat16, "wgrad", k, 1, cin, wshape[0])
                    + ".wgrad"] += 1
            del x, xb, g, x32, w32, y32, want, runs
        torch.cuda.empty_cache()
    got = conv_route.passes()
    if {k: v for k, v in got.items() if v} != dict(want_passes):
        raise AssertionError(f"conv route counts {got}, want "
                             f"{dict(want_passes)}")
    log(f"conv route: {len(shapes)} shapes, passes {got}, the "
        f"largest difference over the largest magnitude by pass {worst}")
    return got


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
    torch.cuda.empty_cache()
    families = timed("phase 14", phase_families, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dmh_cli_") as root:
        commands, files = timed("phase 15", phase_cli_commands, dev, root)
        torch.cuda.empty_cache()
        data_parallel = timed("phase 16", phase_parallel, dev, files)
    torch.cuda.empty_cache()
    classifier_launches = timed("phase 17", phase_classifier, dev)
    timed("phase 18", phase_repeat)
    timed("phase 19", phase_conv_route, dev)
    for name, r in rows.items():
        r["launches"] = (launches[name] + train_launches[name]
                         + distill_launches[name] + bench_launches[name]
                         + harden[name] + cli[name] + zoo[name]
                         + families[name] + commands[name]
                         + data_parallel[name] + classifier_launches[name])
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
