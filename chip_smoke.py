"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: require a CUDA card of capability >= 9.0, print its name and
   power limit as nvidia-smi reports them, switch to plain float32
   numerics (TF32 off, cuDNN off: `device.use_f32_numerics`).
2. build: compile every kernel in depthmodelhardening_tpu_torch/csrc/
   with nvcc into build/torch_kernels/.
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the attack-eval slice gives it: max abs error and
   median CUDA-event time of both.
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

Prints one JSON line of kernel results, then, as the last line,
{"ok": true, "device": {...}}. Needs no network and no jax.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.device import require_cuda, use_f32_numerics
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, _batch_metrics, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import _build, pool, warp

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
GOLDEN_RTOL, GOLDEN_ATOL = 5e-4, 2e-4  # tests/test_golden_fixtures.py
WARP_FWD_ATOL, WARP_BWD_ATOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of `fn()` on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
def phase_build() -> None:
    secs = _build.build_all()
    names = sorted({k.source for k in _build.KERNELS})
    log(f"build: {names} into {os.path.relpath(_build.BUILD_DIR, REPO)} "
        f"in {secs:.1f} s")


# -- phase 3 -----------------------------------------------------------------
def _warp_inputs(gen, dev, Bn, C, OH, TH, TW, ragged: bool):
    inter = torch.rand((Bn, C, OH, TW), generator=gen).to(dev)
    if ragged:
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


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version; returns name -> result row."""
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    def row(kernel, err, ms, plain_ms):
        rows[kernel.name] = dict(
            name=kernel.name, route="cuda", source=kernel.source_path,
            replaces=kernel.replaces, max_abs_err=err, ms=ms,
            plain_ms=plain_ms)
        log(f"  {kernel.name}: max|kernel-plain| {err:.3e}  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")

    for label, shape, ragged in (
            ("slice", (12, 4, 200, 256, 256), False),
            ("ragged", (3, 5, 37, 45, 53), True)):
        Bn, C, OH, TH, TW = shape
        inter, A, B = _warp_inputs(gen, dev, Bn, C, OH, TH, TW, ragged)
        g = torch.randn((Bn, C, TH, TW), generator=gen).to(dev)
        out_k = warp.vertical_resample_fwd_cuda(inter, A, B, TH)
        out_p = warp.vertical_resample_plain(inter, A, B, TH)
        d_k = warp.vertical_resample_bwd_cuda(g, A, B, OH)
        d_p = warp.vertical_resample_adjoint_plain(g, A, B, OH)
        torch.cuda.synchronize()
        e_f = float((out_k - out_p).abs().max())
        e_b = float((d_k - d_p).abs().max())
        log(f"warp {label} {shape}: fwd err {e_f:.3e} (atol "
            f"{WARP_FWD_ATOL}), adjoint err {e_b:.3e} (atol "
            f"{WARP_BWD_ATOL})")
        if not (e_f <= WARP_FWD_ATOL and e_b <= WARP_BWD_ATOL):
            raise AssertionError(f"warp kernel disagrees at {shape}")
        if label == "slice":
            row(warp.FWD, e_f,
                cuda_ms(lambda: warp.vertical_resample_fwd_cuda(
                    inter, A, B, TH)),
                cuda_ms(lambda: warp.vertical_resample_plain(
                    inter, A, B, TH)))
            row(warp.BWD, e_b,
                cuda_ms(lambda: warp.vertical_resample_bwd_cuda(
                    g, A, B, OH)),
                cuda_ms(lambda: warp.vertical_resample_adjoint_plain(
                    g, A, B, OH)))

    # the stem pool sees relu outputs: many exact zeros, so ties are the
    # rule and the equality routing must agree with the plain version
    for shape in ((12, 64, 160, 512), (2, 3, 17, 23)):
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
        if shape[1] == 64:
            row(pool.FWD, e_f,
                cuda_ms(lambda: pool.maxpool3x3s2_fwd_cuda(x)),
                cuda_ms(lambda: pool.maxpool3x3s2_plain(x)))
            row(pool.BWD, e_b,
                cuda_ms(lambda: pool.maxpool3x3s2_bwd_cuda(x, g)),
                cuda_ms(lambda: pool.maxpool3x3s2_backward_plain(x, g)))
    return rows


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
    bad = [n for n, c in launches.items() if c <= 0]
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
    log("breakdown at batch 12, 1024x320 (median CUDA-event ms):")
    for name, fn in parts.items():
        log(f"  {name}: {cuda_ms(fn, reps=10):.3f}")
    for r in rows.values():
        log(f"  kernel {r['name']}: {r['ms']:.4f} (plain {r['plain_ms']:.4f})")


def phase_idle(attack, scenes) -> None:
    """Device idle share of one attack call (10 PGD steps + finals):
    the union of the card's kernel and copy intervals in a torch.profiler
    trace, against the host clock around the call."""
    from torch.profiler import ProfilerActivity, profile

    draws = attack.draw(torch.Generator().manual_seed(SEED + 11),
                        CFG.batch_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        attack(scenes, CFG.batch_size, eval_mode=True, draws=draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith(("Buffer Flush", "Activity Buffer")))
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy_ms = busy_us / 1e3
    log(f"idle: one attack call (PGD-{CFG.step} + finals) under the "
        f"profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms host "
        f"wall, idle share {1.0 - busy_ms / wall_ms:.4f}, "
        f"{len(spans)} device activities")
    if not spans:
        raise AssertionError("the profiler saw no device activity")


def main() -> int:
    dev = phase_device()
    phase_build()
    log("kernels vs plain versions:")
    rows = phase_kernels(dev)
    phase_golden(dev)
    launches, attack, predictor, scenes = phase_slice(dev)
    phase_cost(attack, scenes)
    phase_breakdown(attack, predictor, scenes, rows)
    phase_idle(attack, scenes)
    for name, r in rows.items():
        r["launches"] = launches[name]
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms")}
        for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
