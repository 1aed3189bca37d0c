"""Single typed-config CLI of the port.

Counterpart of `depthmodelhardening_tpu/cli/main.py` (the reference's
simple_adv_training.py, DepthNetworks/*/train.py, evaluate_depth*.py,
test_simple.py, precompute_depth_hints.py, export_gt_depth.py):

  python -m depthmodelhardening_tpu_torch.cli <subcommand> [...]
  dmh-torch <subcommand> [...]

Subcommands: infer, eval-attacks, eval-clean, train-distill,
train-hardening, precompute-hints, export-gt-depths, fetch-splits, with
the JAX CLI's options and defaults, less its TPU layout flags
(`--s2d-stem`, `--wpack-stem`, `--fuse-upconv`, `--packed-decoder`,
`--wpack-decoder`: ROADMAP "Not to port"), which argparse rejects.

`main(argv=None, device=None)` returns the subcommand's result (the
metrics of the evaluations, the trained state of the trainers). The
subcommands that run a model run on the card: `device=None` is the
current CUDA device (`device.resolve_device`, which raises without
one); tests pass device="cpu" from Python, and the command line has no
such flag, as the JAX CLI has none. export-gt-depths and fetch-splits
run on the host only.

Where the port differs from the JAX CLI, each a standing difference
(ROADMAP Queue 3):

* random draws: the trainers draw from a `torch.Generator` seeded from
  --seed, and a resumed run restores its states from the checkpoint
  (`save_state(..., trainer=)`), where the JAX CLI takes a new key each
  step (`PRNGKey(seed * 100003 + step)`);
* without --weights-folder the model is `init_monodepth2(
  torch.Generator().manual_seed(0))`: flax's initialisation, not JAX's
  PRNGKey(0) weights.

`train-hardening --data-parallel` trains over torch.distributed, one
process a device: launched by torchrun (`torchrun --nproc-per-node N -m
depthmodelhardening_tpu_torch.cli train-hardening --data-parallel ...`:
cuda:LOCAL_RANK, NCCL), or alone as a world of one. --batch-size and
--attack-batch-size are the global batches, as in the JAX CLI, and must
divide by the world size. Rank 0 alone writes opt.json and the
checkpoints, logs and runs the robustness val, while the other ranks
wait at a barrier; every rank resumes from the same checkpoint.

`infer` reads and resizes its image with PIL; `precompute-hints` needs
cv2 and PIL (`data/depth_hints.py` raises ImportError naming them);
`--dump-dir` and train-distill's comparison images need PIL and
matplotlib (train-distill says so and logs its scalars without them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

def _device(device) -> torch.device:
    from ..device import resolve_device, use_f32_numerics

    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_numerics()
    return dev


def _add_common_model_args(p):
    p.add_argument("--weights-folder", type=str, default=None,
                   help="reference-format weights_*/ folder with "
                        "encoder.pth + depth.pth")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--num-layers", type=int, default=18)


def _load_predictor(args, device):
    """(model, DepthPredictor of disp0) on `device`, float32: the weights
    folder's, or flax's initialisation from a generator seeded with 0."""
    from ..models.wrappers import (
        init_monodepth2, make_monodepth2, predictor_from,
    )

    if args.weights_folder:
        from ..training.checkpoints import load_reference_pth

        model = make_monodepth2(num_layers=args.num_layers)
        model.load_state_dict(load_reference_pth(args.weights_folder)[0])
    else:
        model = init_monodepth2(torch.Generator().manual_seed(0),
                                num_layers=args.num_layers)
    model = model.to(device)
    return model, predictor_from(model)


def _panel_modules_missing():
    """The first of PIL and matplotlib that does not import, or None."""
    for name in ("PIL", "matplotlib"):
        try:
            __import__(name)
        except ImportError:
            return name
    return None


def cmd_infer(args, device):
    """test_simple.py equivalent: disparity for one image ->
    colormapped JPEG + metric-depth npy (test_simple.py:95-160)."""
    from ..native import require_pil
    from ..ops.geometry import disp_to_depth
    from ..ops.resize import bilinear_resize
    from ..utils.visualize import colormap_disp

    Image = require_pil("infer")
    _, predictor = _load_predictor(args, device)

    with open(args.image, "rb") as f:
        img = Image.open(f).convert("RGB")
    ow, oh = img.size
    x = np.asarray(img.resize((args.width, args.height)),
                   np.float32)[None] / 255.0
    with torch.no_grad():
        disp = predictor(torch.from_numpy(x).to(device))
        disp_full = bilinear_resize(disp, oh, ow)
        scaled_disp, _ = disp_to_depth(disp_full, 0.1, 100)

    base = os.path.splitext(args.image)[0]
    scaled_disp = scaled_disp.cpu().numpy()
    np.save(base + "_disp.npy", scaled_disp)
    d = disp_full[0, ..., 0].cpu().numpy()
    Image.fromarray(colormap_disp(d)).save(base + "_disp.jpeg")
    print(f"saved {base}_disp.npy and {base}_disp.jpeg")
    return scaled_disp


def cmd_eval_attacks(args, device):
    from ..data.kitti_object import KittiObjectScenes
    from ..data.object_images import process_car_img
    from ..evaluation.attack_eval import (
        AttackEvalConfig, build_attack, evaluate_attacks,
        iter_eval_scenes,
    )

    _, predictor = _load_predictor(args, device)
    obj, car_mask, _ = process_car_img(args.object_image,
                                       args.paint_mask_no)
    if args.preset:
        from ..evaluation.presets import EVAL_PRESETS

        cfg = dataclasses.replace(
            EVAL_PRESETS[args.preset], eval_count=args.eval_count,
            scene_h=args.height, scene_w=args.width,
            ori_h=args.ori_h, ori_w=args.ori_w,
            dump_dir=args.dump_dir)
    else:
        cfg = AttackEvalConfig(
            norm_type=args.norm_type, epsilon=args.epsilon,
            alpha=args.alpha, step=args.step, adam_lr=args.adam_lr,
            mask_wt=args.mask_wt, l0_thresh=args.l0_thresh,
            batch_size=args.batch_size, eval_count=args.eval_count,
            scene_h=args.height, scene_w=args.width,
            ori_h=args.ori_h, ori_w=args.ori_w,
            dump_dir=args.dump_dir)
    attack = build_attack(cfg, predictor, obj, car_mask)
    dataset = KittiObjectScenes(args.object_data_root, mode="val",
                                size=(cfg.ori_w, cfg.ori_h),
                                train_list=args.train_list,
                                val_list=args.val_list)
    res = evaluate_attacks(predictor, attack,
                           iter_eval_scenes(dataset, cfg), cfg,
                           generator=torch.Generator().manual_seed(17))
    print(json.dumps(res, indent=2))
    return res


def cmd_eval_clean(args, device):
    from ..data.kitti_raw import (
        KittiRawDataset, load_image_resized, load_split,
    )
    from ..evaluation.clean_eval import CleanEvalConfig, evaluate_clean

    _, predictor = _load_predictor(args, device)
    lines = load_split(args.split_dir, args.split, "test")
    ds = KittiRawDataset(args.data_path, lines, frame_ids=("0",))
    gt = np.load(os.path.join(args.split_dir, args.split,
                              "gt_depths.npz"),
                 allow_pickle=True)["data"]

    def pairs():
        for i, line in enumerate(ds.lines):
            # single direct resize to working resolution, like the
            # reference evaluator (no native-res intermediate)
            img = load_image_resized(
                ds.image_path(line.folder, line.frame_index,
                              line.side or "l"),
                args.height, args.width)
            yield img, np.asarray(gt[i], dtype=np.float32)

    cfg = CleanEvalConfig(eval_stereo=not args.eval_mono,
                          post_process=args.post_process)
    metrics, _ = evaluate_clean(predictor, pairs(), cfg)
    print(json.dumps(metrics, indent=2))
    return metrics


def cmd_train_distill(args, device):
    from ..data.kitti_object import KittiObjectScenes
    from ..data.object_images import process_car_img
    from ..models.wrappers import make_monodepth2, predictor_from
    from ..training.checkpoints import export_reference_pth, save_options
    from ..training.config import DistillConfig
    from ..training.distill import DistillTrainer
    from ..utils.logging import MetricsLogger

    model, _ = _load_predictor(args, device)
    obj, car_mask, _ = process_car_img(args.object_image,
                                       args.paint_mask_no)
    cfg = DistillConfig(adv_type=args.adv_type, epsilon=args.epsilon,
                        alpha=args.alpha, steps=args.step,
                        batch_size=args.batch_size,
                        scene_h=args.height, scene_w=args.width,
                        ori_h=args.ori_h, ori_w=args.ori_w,
                        learning_rate=args.lr,
                        compute_dtype=args.compute_dtype,
                        attack_crop_w=args.attack_crop_w,
                        attack_crop_h=args.attack_crop_h,
                        attack_scale=args.attack_scale,
                        attack_scale_fine_steps=args.attack_scale_fine_steps)
    # The frozen teacher only ever supplies disp0 pseudo-GT, so it runs
    # as a scales=(0,) float32 twin (the other heads' weights dropped).
    teacher_model = make_monodepth2(num_layers=args.num_layers, scales=(0,))
    keep = teacher_model.state_dict().keys()
    teacher_model.load_state_dict({k: v for k, v in
                                   model.state_dict().items() if k in keep})
    teacher = predictor_from(teacher_model.to(device))
    trainer = DistillTrainer(cfg, torch.Generator().manual_seed(args.seed),
                             obj, car_mask, teacher, device=device,
                             num_layers=args.num_layers,
                             init_state_dict=model.state_dict())
    state = trainer.make_state()
    save_options(args.log_dir, cfg)

    train_set = KittiObjectScenes(args.object_data_root, mode="train",
                                  size=(cfg.ori_w, cfg.ori_h),
                                  train_list=args.train_list,
                                  val_list=args.val_list)
    # per-epoch robustness eval on held-out scenes
    # (simple_adv_training.py:148 eval_atk_perf every epoch)
    val_set = None
    if args.eval_count:
        val_set = KittiObjectScenes(args.object_data_root, mode="val",
                                    size=(cfg.ori_w, cfg.ori_h),
                                    train_list=args.train_list,
                                    val_list=args.val_list)
    logger = MetricsLogger(args.log_dir)
    image_logger = logger
    missing = _panel_modules_missing()
    if val_set is not None and missing:
        image_logger = None
        print(f"eval/model_comp and eval/atk_comp images are not written: "
              f"the panel needs {missing}, which is not installed")

    def run_val(epoch):
        if val_set is None:
            return
        from ..evaluation.attack_eval import (
            AttackEvalConfig, iter_eval_scenes,
        )
        from ..training.distill import eval_atk_perf

        # single scenes from start_idx=42, replicated by the attack
        # (simple_adv_training.py:64-74)
        scenes_iter = iter_eval_scenes(
            val_set, AttackEvalConfig(), batch_size=1,
            count=args.eval_count)
        model_perf, atk_perf = eval_atk_perf(
            trainer, state, scenes_iter,
            torch.Generator().manual_seed(17), logger=image_logger,
            epoch=epoch)
        logger.log(step, {"eval/model_perf": model_perf,
                          "eval/atk_perf": atk_perf})
        print(f"epoch {epoch} model_perf {model_perf:.4f} "
              f"atk_perf {atk_perf:.4f}")

    step = 0
    try:
        for epoch in range(args.epochs):
            for scenes, _ in train_set.batches(cfg.batch_size,
                                               seed=epoch):
                state, metrics = trainer.train_step(state, scenes)
                if step % 30 == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    logger.log(step, scalars)
                    print(f"epoch {epoch} step {step} "
                          f"loss {scalars['loss']:.5f}")
                step += 1
            run_val(epoch)
            if epoch % 2 == 0:
                export_reference_pth(args.log_dir, epoch + 1,
                                     state.model.state_dict(),
                                     height=args.height, width=args.width)
        export_reference_pth(args.log_dir, "final", state.model.state_dict(),
                             height=args.height, width=args.width)
    finally:
        logger.close()
    return state


def cmd_train_hardening(args, device):
    from ..data.kitti_object import KittiObjectScenes
    from ..data.kitti_raw import KittiRawDataset, collate, load_split
    from ..data.loader import PrefetchLoader
    from ..data.object_images import process_car_img
    from ..parallel.mesh import make_mesh, shard_batch
    from ..training.checkpoints import (
        latest_step, restore_state, save_options, save_state,
    )
    from ..training.config import (
        AdvSynthConfig, HardeningConfig, SelfSupConfig,
    )
    from ..training.hardening import HardeningTrainer
    from ..utils.logging import MetricsLogger

    mesh = make_mesh(device) if args.data_parallel else None
    # rank 0 writes, logs and validates; the others wait at a barrier
    lead = mesh is None or mesh.rank == 0
    barrier = (lambda: None) if mesh is None else mesh.barrier
    model, predictor = _load_predictor(args, device)
    # the frozen distillation teacher is the pretrained model; a
    # separate folder may override it (trainer.py:93-95 gt_model)
    if args.teacher_weights:
        targs = argparse.Namespace(
            **{**vars(args), "weights_folder": args.teacher_weights})
        _, teacher = _load_predictor(targs, device)
    else:
        teacher = predictor
    # --fine-tune starts the student from the pretrained weights
    # (trainer.py:70-91); otherwise the student is randomly initialized
    init_sd = None
    if args.fine_tune:
        if not args.weights_folder:
            raise SystemExit("--fine-tune requires --weights-folder")
        init_sd = model.state_dict()
    obj, car_mask, _ = process_car_img(args.object_image,
                                       args.paint_mask_no)

    frame_ids = tuple(args.frame_ids.split(","))
    adv_train = not args.no_adv_train
    cfg = HardeningConfig(
        selfsup=SelfSupConfig(height=args.height, width=args.width,
                              frame_ids=frame_ids,
                              avg_reprojection=args.avg_reprojection,
                              disable_automasking=args.disable_automasking,
                              v1_multiscale=args.v1_multiscale),
        adv=AdvSynthConfig(norm_type=args.norm_type, steps=args.step,
                           attack_batch_size=args.attack_batch_size,
                           attack_crop_w=args.attack_crop_w,
                           attack_crop_h=args.attack_crop_h,
                           attack_scale=args.attack_scale,
                           attack_scale_fine_steps=(
                               args.attack_scale_fine_steps),
                           half_no_synthesis=args.half_no_synthesis,
                           ori_h=args.ori_h, ori_w=args.ori_w),
        supervised_adv=args.supervised_adv and adv_train,
        contrastive_learning=args.contrastive_learning and adv_train,
        no_original_train=args.no_original_train,
        gt_depth=args.gt_depth,
        learning_rate=args.lr, batch_size=args.batch_size,
        compute_dtype=args.compute_dtype,
        use_depth_hints=args.use_depth_hints,
        model_family=args.model_family,
        manydepth_real_lookup=args.manydepth_real_lookup)

    lines = load_split(args.split_dir, args.split, "train")
    ds = KittiRawDataset(args.data_path, lines, frame_ids=frame_ids,
                         ori_h=args.ori_h, ori_w=args.ori_w)
    loader = PrefetchLoader(ds, cfg.batch_size, collate, seed=args.seed,
                            device=device, mesh=mesh)
    steps_per_epoch = max(len(loader), 1)

    trainer = HardeningTrainer(
        cfg, torch.Generator().manual_seed(args.seed), obj, car_mask,
        teacher=teacher if cfg.supervised_adv else None, device=device,
        steps_per_epoch=steps_per_epoch, init_state_dict=init_sd, mesh=mesh)
    state = trainer.make_state()
    # resume from the latest checkpoint when present (the reference
    # resumes via --load_weights_folder, trainer.py:787-812), the
    # trainer's generators included
    ckpt_dir = os.path.join(args.log_dir, "ckpts")
    resume = latest_step(ckpt_dir)
    if resume is not None:
        state = restore_state(ckpt_dir, state, trainer=trainer)
        if lead:
            print(f"resumed from step {int(state.step)} "
                  f"(checkpoint {resume})")
    if lead:
        save_options(args.log_dir, cfg)
    barrier()
    # continue the global step count so checkpoint numbering advances
    # instead of replaying from 0
    step = int(state.step)

    scene_set = KittiObjectScenes(args.object_data_root, mode="train",
                                  size=(cfg.adv.ori_w, cfg.adv.ori_h),
                                  train_list=args.train_list,
                                  val_list=args.val_list)
    scene_iter = iter(scene_set.batches(cfg.adv.attack_batch_size))

    # periodic robustness val on held-out scenes (trainer.py:435-470
    # runs evaluate_attacks on the in-training student every log step)
    val_frequency = args.val_frequency
    if val_frequency is None:
        # each robustness val costs a full attack-eval loop (an attack
        # optimization per batch), so default it 10x sparser than
        # scalar logging
        val_frequency = 10 * args.log_frequency if adv_train else 0
    val_scene_set = val_eval_cfg = None
    if val_frequency:
        val_scene_set = KittiObjectScenes(
            args.object_data_root, mode="val",
            size=(cfg.adv.ori_w, cfg.adv.ori_h),
            train_list=args.train_list, val_list=args.val_list)
        val_eval_cfg = trainer.default_eval_cfg(
            eval_count=args.val_eval_count)

    logger = MetricsLogger(args.log_dir) if lead else None
    try:
        for epoch in range(args.epochs):
            for batch in loader:
                if adv_train:
                    try:
                        scenes, _ = next(scene_iter)
                    except StopIteration:
                        scene_iter = iter(scene_set.batches(
                            cfg.adv.attack_batch_size, seed=epoch))
                        scenes, _ = next(scene_iter)
                    if mesh is not None:
                        scenes = shard_batch(scenes, mesh)
                    state, metrics = trainer.train_step(
                        state, batch["frames"], batch["side_is_l"],
                        batch["do_flip"], scenes)
                else:
                    state, metrics = trainer.selfsup_frames_step(
                        state, batch["frames"], batch["side_is_l"],
                        batch["do_flip"])
                if lead and step % args.log_frequency == 0:
                    scalars = {k: float(v)
                               for k, v in metrics.items()}
                    logger.log(step, scalars)
                    print(f"epoch {epoch} step {step} " + " ".join(
                        f"{k}={v:.5f}" for k, v in scalars.items()))
                if val_frequency and adv_train and \
                        step % val_frequency == 0:
                    if lead:
                        _val(trainer, state, val_scene_set, val_eval_cfg,
                             logger, step)
                    barrier()
                step += 1
            if lead:
                save_state(ckpt_dir, step, state, trainer=trainer)
            barrier()
    finally:
        if logger is not None:
            logger.close()
    return state


def _val(trainer, state, val_scene_set, val_eval_cfg, logger, step) -> None:
    """The robustness of the in-training student: attack it on held-out
    scenes and log the masked depth-error suite (trainer.py:435-470
    val())."""
    from ..evaluation.attack_eval import iter_eval_scenes

    res = trainer.evaluate_attacks(
        state, iter_eval_scenes(val_scene_set, val_eval_cfg),
        eval_cfg=val_eval_cfg, generator=torch.Generator().manual_seed(17))
    logger.log(step, {f"val/{agg}_{name}": v for agg, row in res.items()
                      for name, v in row.items()})
    print(f"  val step {step} atk_abs_err={res['mean']['abs_err']:.4f} "
          f"atk_rmse={res['mean']['rmse']:.4f}")


def cmd_precompute_hints(args, device):
    from ..data.depth_hints import precompute_for_split
    from ..data.kitti_raw import readlines

    written = precompute_for_split(
        args.data_path, readlines(args.filenames),
        save_path=args.save_path, height=args.height,
        width=args.width, overwrite=args.overwrite, device=device)
    print(f"wrote {len(written)} depth hints")
    return written


def cmd_export_gt(args):
    from ..data.kitti_raw import export_gt_depths

    out = export_gt_depths(args.data_path, args.split_dir, args.split)
    print(f"saved {out}")
    return out


def cmd_fetch_splits(args):
    from ..data import splits as sp

    names = args.splits.split(",") if args.splits else None
    if args.from_dir:
        files = sp.import_splits(args.from_dir, args.dest, names)
    elif args.generate_odom:
        files = sp.make_odom_split(args.dest)
    else:
        files = sp.fetch_splits(args.dest, names)
    print(f"wrote {len(files)} split files under {args.dest}")
    return files


def _add_perf_args(p):
    p.add_argument("--attack-crop-w", type=int, default=None,
                   help="width-cropped attack objective "
                        "(attacks/base.py); None = full frame")
    p.add_argument("--attack-crop-h", type=int, default=None,
                   help="height companion to --attack-crop-w")
    p.add_argument("--attack-scale", type=int, default=0,
                   choices=(0, 1, 2),
                   help="PGD-loop objective from the scale-s disparity "
                        "head (skips the /1 decoder stages per inner "
                        "step; 0 = reference disp0 objective)")
    p.add_argument("--attack-scale-fine-steps", type=int, default=1,
                   help="with --attack-scale > 0: how many of the LAST "
                        "inner steps read the reference disp0 "
                        "objective (coarse-to-fine)")


def build_parser():
    p = argparse.ArgumentParser(prog="depthmodelhardening_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("infer", help="single-image depth inference")
    _add_common_model_args(pi)
    pi.add_argument("--image", required=True)
    pi.set_defaults(fn=cmd_infer, on_device=True)

    pe = sub.add_parser("eval-attacks")
    _add_common_model_args(pe)
    pe.add_argument("--object-data-root", required=True)
    pe.add_argument("--object-image", required=True)
    pe.add_argument("--paint-mask-no", default="-2")
    pe.add_argument("--norm-type", default="l_0")
    pe.add_argument("--preset", default=None,
                    help="reference eval-zoo preset name "
                         "(evaluation/presets.py)")
    pe.add_argument("--epsilon", type=float, default=0.1)
    pe.add_argument("--alpha", type=float, default=0.005)
    pe.add_argument("--step", type=int, default=10)
    pe.add_argument("--adam-lr", type=float, default=0.5)
    pe.add_argument("--mask-wt", type=float, default=0.06)
    pe.add_argument("--l0-thresh", type=float, default=0.1)
    pe.add_argument("--batch-size", type=int, default=12)
    pe.add_argument("--eval-count", type=int, default=10)
    pe.add_argument("--dump-dir", default=None,
                    help="save attacked/benign scenes + disparity "
                         "panels per batch")
    pe.add_argument("--ori-h", type=int, default=375)
    pe.add_argument("--ori-w", type=int, default=1242)
    pe.add_argument("--train-list", default="trainval.txt")
    pe.add_argument("--val-list", default="test.txt")
    pe.set_defaults(fn=cmd_eval_attacks, on_device=True)

    pc = sub.add_parser("eval-clean")
    _add_common_model_args(pc)
    pc.add_argument("--data-path", required=True)
    pc.add_argument("--split-dir", required=True)
    pc.add_argument("--split", default="eigen")
    pc.add_argument("--eval-mono", action="store_true")
    pc.add_argument("--post-process", action="store_true")
    pc.set_defaults(fn=cmd_eval_clean, on_device=True)

    pd = sub.add_parser("train-distill")
    _add_common_model_args(pd)
    pd.add_argument("--object-data-root", required=True)
    pd.add_argument("--object-image", required=True)
    pd.add_argument("--paint-mask-no", default="-2")
    pd.add_argument("--adv-type", default="object",
                    choices=["object", "object_l0", "image"])
    pd.add_argument("--epsilon", type=float, default=0.1)
    pd.add_argument("--alpha", type=float, default=0.005)
    pd.add_argument("--step", type=int, default=10)
    pd.add_argument("--batch-size", type=int, default=16)
    pd.add_argument("--lr", type=float, default=1e-4)
    pd.add_argument("--epochs", type=int, default=20)
    pd.add_argument("--seed", type=int, default=17)
    pd.add_argument("--ori-h", type=int, default=375)
    pd.add_argument("--ori-w", type=int, default=1242)
    pd.add_argument("--eval-count", type=int, default=5,
                    help="scenes per per-epoch robustness eval "
                         "(the reference uses 50, "
                         "simple_adv_training.py:64; 0 disables)")
    pd.add_argument("--log-dir", default="./logs/distill")
    pd.add_argument("--compute-dtype", default="bfloat16")
    pd.add_argument("--train-list", default="trainval.txt")
    pd.add_argument("--val-list", default="test.txt")
    _add_perf_args(pd)
    pd.set_defaults(fn=cmd_train_distill, on_device=True)

    ph = sub.add_parser("train-hardening")
    _add_common_model_args(ph)
    ph.add_argument("--data-path", required=True)
    ph.add_argument("--split-dir", required=True)
    ph.add_argument("--split", default="eigen_full")
    ph.add_argument("--object-data-root", required=True)
    ph.add_argument("--object-image", required=True)
    ph.add_argument("--paint-mask-no", default="-2")
    ph.add_argument("--frame-ids", default="0,s")
    ph.add_argument("--ori-h", type=int, default=375,
                    help="native scene resolution the loader resizes "
                         "to (my_utils.py:12-13)")
    ph.add_argument("--ori-w", type=int, default=1242)
    ph.add_argument("--norm-type", default="l_0")
    ph.add_argument("--step", type=int, default=10)
    ph.add_argument("--attack-batch-size", type=int, default=12)
    ph.add_argument("--batch-size", type=int, default=32)
    ph.add_argument("--lr", type=float, default=1e-5)
    ph.add_argument("--epochs", type=int, default=20)
    ph.add_argument("--seed", type=int, default=17)
    ph.add_argument("--fine-tune", action="store_true",
                    help="start the student from --weights-folder "
                         "(the reference recipe hardens a pretrained "
                         "model, trainer.py:70-91)")
    ph.add_argument("--teacher-weights", default=None,
                    help="separate weights folder for the frozen "
                         "distillation teacher (defaults to "
                         "--weights-folder)")
    ph.add_argument("--val-frequency", type=int, default=None,
                    help="steps between robustness evals on held-out "
                         "scenes (default: 10x --log-frequency = 250; "
                         "0 disables). Each val runs a full attack-eval "
                         "loop over --val-eval-count batches")
    ph.add_argument("--val-eval-count", type=int, default=2,
                    help="eval batches per robustness check (the "
                         "reference uses 10, trainer.py:455-465)")
    ph.add_argument("--supervised-adv",
                    action=argparse.BooleanOptionalAction, default=True)
    ph.add_argument("--contrastive-learning",
                    action=argparse.BooleanOptionalAction, default=True)
    ph.add_argument("--use-depth-hints", action="store_true")
    ph.add_argument("--gt-depth", action="store_true",
                    help="supervised branch composites the object's "
                         "true distance inside its mask "
                         "(options.py:227-229, trainer.py:546-565)")
    ph.add_argument("--half-no-synthesis", action="store_true",
                    help="keep a random half of each batch raw "
                         "(options.py:153-156)")
    ph.add_argument("--no-original-train", action="store_true",
                    help="drop the self-supervised loss "
                         "(options.py:150-152)")
    ph.add_argument("--avg-reprojection", action="store_true")
    ph.add_argument("--disable-automasking", action="store_true")
    ph.add_argument("--v1-multiscale", action="store_true")
    ph.add_argument("--no-adv-train", action="store_true",
                    help="vanilla self-supervised training (the "
                         "reference trainer with adv_train off)")
    _add_perf_args(ph)
    ph.add_argument("--model-family", default="monodepth2",
                    choices=["monodepth2", "manydepth"])
    ph.add_argument("--manydepth-real-lookup", action="store_true",
                    help="build the cost volume from the real previous "
                         "frame + pose-net pose instead of the "
                         "reference's zero lookups (beyond-reference; "
                         "needs monocular --frame-ids, e.g. -1,0,1,s)")
    ph.add_argument("--data-parallel", action="store_true",
                    help="train over torch.distributed, one process a "
                         "device (torchrun's; alone: a world of one); "
                         "--batch-size is the global batch")
    ph.add_argument("--log-dir", default="./logs/hardening")
    ph.add_argument("--log-frequency", type=int, default=25)
    ph.add_argument("--compute-dtype", default="bfloat16")
    ph.add_argument("--train-list", default="trainval.txt")
    ph.add_argument("--val-list", default="test.txt")
    ph.set_defaults(fn=cmd_train_hardening, on_device=True)

    pp = sub.add_parser("precompute-hints")
    pp.add_argument("--data-path", required=True)
    pp.add_argument("--filenames", required=True)
    pp.add_argument("--save-path", default=None)
    pp.add_argument("--height", type=int, default=320)
    pp.add_argument("--width", type=int, default=1024)
    pp.add_argument("--overwrite", action="store_true")
    pp.set_defaults(fn=cmd_precompute_hints, on_device=True)

    pg = sub.add_parser("export-gt-depths")
    pg.add_argument("--data-path", required=True)
    pg.add_argument("--split-dir", required=True)
    pg.add_argument("--split", default="eigen")
    pg.set_defaults(fn=cmd_export_gt, on_device=False)

    ps = sub.add_parser(
        "fetch-splits",
        help="download/import/generate KITTI split lists")
    ps.add_argument("--dest", required=True)
    ps.add_argument("--from-dir", default=None,
                    help="import from a local Monodepth2-style "
                         "splits directory instead of downloading")
    ps.add_argument("--generate-odom", action="store_true",
                    help="generate the odometry split locally")
    ps.add_argument("--splits", default=None,
                    help="comma-separated subset, e.g. eigen,odom")
    ps.set_defaults(fn=cmd_fetch_splits, on_device=False)

    return p


def main(argv=None, device=None):
    """Run one subcommand; returns its result. device: where a model
    runs (default the current CUDA card; raises without one)."""
    args = build_parser().parse_args(argv)
    if args.on_device:
        if device is None and getattr(args, "data_parallel", False):
            from ..parallel.mesh import local_device

            device = local_device()  # this process's card under torchrun
        return args.fn(args, _device(device))
    return args.fn(args)


def run(argv=None) -> int:
    """The console script's entry point: `main`, exit status 0."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(run())
