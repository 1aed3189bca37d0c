"""Training cells: the hardening step and the plain self-supervised step.

Set-up builds one trainer and one state from the benchmark's seeded
weights (the student's, the SimSiam head's and, where the frame ids hold
temporal frames, the pose networks') and drives them through `RECORDED`
steps on pool batches 0, 1 and 2 (rows that all differ), through the
window's own call and feed:
the step method of the program's `HardeningTrainer` with the
benchmark's inputs and draws. Those steps are also the warm-up of every
shape the window uses. The window then steps the same state on, batch
after batch of the pool. Once it has closed and the program's state is
freed, the plain reference (`reference/plain`, float32, TF32 off)
follows the recorded steps from the same weights, inputs, draws and
(with an attack) the program's textures, checks the attack stage by
itself, and `readings` compares the two.
"""

from __future__ import annotations

import functools
import statistics
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from . import traffic as T
from .faults import start_texture

RECORDED = 3
ADAM_BETA1 = 0.9
# the float32 rounding of one texture composited twice (clamp(obj + pp +
# pn) in the program and again in the reference): a judged texture within
# it of the attack's start is the start
STAYED = 1e-6


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def make_config(mod, spec: dict, dtype: str = None):
    """The cell's HardeningConfig, built from its configuration's and
    traffic's files with the dataclasses of `mod` (the program's
    `training.config` or the reference's), in `dtype` if given."""
    cfg, tr = spec["config"], spec["traffic"]
    hard = {"num_layers": cfg["num_layers"], **cfg.get("hardening", {}),
            **tr.get("hardening", {})}
    if dtype is not None:
        hard["compute_dtype"] = dtype
    ss = mod.SelfSupConfig(height=cfg["height"], width=cfg["width"],
                           **_tuples(tr.get("selfsup", {})))
    adv = mod.AdvSynthConfig(ori_h=tr["scene"][0], ori_w=tr["scene"][1],
                             **tr.get("adv", {}))
    return mod.HardeningConfig(selfsup=ss, adv=adv, **_tuples(hard))


class _NoTeacher:
    """The draws need the trainer's attack, not its teacher."""

    def __call__(self, images):
        raise RuntimeError("the drawing trainer predicts nothing")


def _named_params(state) -> Dict[str, torch.Tensor]:
    return {f"{key}.{n}": p for key, m in state.modules().items()
            for n, p in m.named_parameters()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    vals = torch.stack([tensors[k].detach().float().norm()
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


class TrainCell:
    """One training cell on `dev`: `setup()`, then `step(i)` as often as
    the window asks, `layers()` for the traced run, `free()`, then
    `readings()`."""

    kind = "train"

    def __init__(self, spec: dict, seed: int, dev: torch.device, port,
                 reference):
        self.spec, self.seed, self.dev = spec, seed, dev
        self.P, self.R = port, reference
        self.tr = spec["traffic"]
        self.harden = self.tr["step"] == "harden"
        self.cfg = make_config(port.config, spec)
        self.ref_cfg = make_config(reference.config, spec, "float32")
        self.batch = self.cfg.batch_size
        self.images_per_step = self.batch
        self.record = {}

    # -- inputs ---------------------------------------------------------------
    def _gen(self, stream: int):
        return T.generator(self.seed, stream, self.dev)

    def _weights(self) -> Dict[str, dict]:
        """The state dicts of the trained modules, by the state's names:
        the student's (and teacher's) "model", the SimSiam head's and,
        with temporal frames, "pose_encoder" and "pose_decoder", made on
        the card from the seed with the reference's modules. The model's
        BatchNorm statistics are calibrated on 4 seeded scenes; with
        temporal frames the pose encoder's too, on those scenes' pairs
        with their temporal frames, and with a real lookup the model's
        through the multi-frame forward on the lookup frame and the pose
        networks' transform of it."""
        R, cfg = self.R, self.ref_cfg
        model = R.make_family_model(cfg).to(self.dev)
        T.seeded_init_(model, self._gen(1))
        ss = cfg.selfsup
        h, w = self.tr["scene"]
        scenes = T.scenes(self._gen(2), 4, h, w, self.dev)
        calib = R.bilinear_resize(scenes, ss.height, ss.width)
        modules, pose, forward = {"model": model}, {}, None
        if ss.use_pose_net:
            pose["pose_encoder"], pose["pose_decoder"], forward = self._poses(
                model, scenes, calib)
        T.calibrate_(model, calib, forward)
        if cfg.contrastive_learning:
            head = R.SimSiam(in_dim=R.encoder_channels(cfg.num_layers)[-1])
            T.seeded_init_(head.to(self.dev), self._gen(3))
            modules["simsiam"] = head
        return {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
                for k, m in {**modules, **pose}.items()}

    def _poses(self, model, scenes, calib):
        """(pose encoder, pose decoder, the model's calibration pass): the
        pose networks seeded on their own stream, the encoder's BatchNorm
        statistics calibrated as the step's `predict_poses` runs it on the
        calibration scenes and their temporal frames; with a real lookup,
        the multi-frame forward on the first temporal source and the
        calibrated networks' transform of it, else None."""
        R, cfg, ss = self.R, self.ref_cfg, self.ref_cfg.selfsup
        enc, dec = (m.to(self.dev) for m in R.make_pose_nets())
        T.seeded_init_(torch.nn.ModuleList([enc, dec]), self._gen(6))
        color = {"0": calib, **{
            fid: R.bilinear_resize(f, ss.height, ss.width)
            for fid, f in T.temporal_frames(
                scenes, ss.temporal_source_ids,
                self.tr["temporal_zoom"]).items()}}
        predict = functools.partial(
            R.HardeningTrainer.predict_poses, SimpleNamespace(cfg=cfg),
            SimpleNamespace(pose_encoder=enc, pose_decoder=dec))
        T.calibrate_(enc, color, predict)
        if not cfg.manydepth_real_lookup:
            return enc, dec, None
        enc.eval()
        with torch.no_grad():
            poses = predict(color)
        enc.train()
        fid = ss.temporal_source_ids[0]
        return enc, dec, functools.partial(
            model.features_and_disps_multi, lookup_frames=color[fid][:, None],
            rel_poses=poses[fid][:, None])

    def _inputs(self, k: int):
        """Pool batch k: frames, sides, flips (and the attack's scene)."""
        h, w = self.tr["scene"]
        gen = self._gen(100 + k)
        f0 = T.scenes(gen, self.batch, h, w, self.dev)
        frames = T.stereo_frames(f0, self.tr["stereo_shift"])
        if self.cfg.selfsup.use_pose_net:
            frames.update(T.temporal_frames(
                f0, self.cfg.selfsup.temporal_source_ids,
                self.tr["temporal_zoom"]))
        if self.cfg.use_depth_hints:
            ss = self.cfg.selfsup
            frames["depth_hint"], frames["depth_hint_mask"] = T.depth_hints(
                gen, self.batch, ss.height, ss.width, w,
                self.tr["stereo_shift"], self.dev)
        side, flip = T.sides_and_flips(self.batch, self.dev)
        scene = T.scenes(gen, 1, h, w, self.dev) if self.harden else None
        return frames, side, flip, scene

    def _draws(self):
        """One step's draws: the attack's and the synthesis' from the
        host generator (as the trainer's own `draw` makes them), the
        automask's noise on the card."""
        noise = torch.randn(self.drawer.identity_noise_shape(self.batch),
                            generator=self.noise_gen, device=self.dev)
        if not self.harden:
            return noise
        d = self.drawer.draw(self.batch, self.host_gen)
        d.identity_noise = noise
        return d

    # -- the program ----------------------------------------------------------
    def _trainer(self, mod, cfg):
        sd = self.weights["model"]
        teacher = None
        if cfg.supervised_adv:
            t = mod.make_family_model(cfg)
            t.load_state_dict(sd)
            teacher = mod.predictor_from(t.to(self.dev))
        trainer = mod.HardeningTrainer(
            cfg, torch.Generator().manual_seed(self.seed % (1 << 62) + 7),
            self.obj, self.mask, teacher, device=self.dev,
            init_state_dict=sd)
        resume = {**self.weights, "step": 0,
                  "adam": {k: {} for k in self.weights}}
        return trainer, trainer.make_state(resume=resume)

    def _call(self, trainer, state, inputs, draws):
        frames, side, flip, scene = inputs
        if self.harden:
            return trainer.train_step(state, frames, side, flip, scene,
                                      draws=draws)
        return trainer.selfsup_frames_step(state, frames, side, flip,
                                           identity_noise=draws)

    def _mark(self, part: str) -> None:
        """Seconds of each part of the set-up, for the run's log."""
        now = time.perf_counter()
        self.setup_parts[part] = now - self._t
        self._t = now

    def setup(self) -> None:
        self.setup_parts, self._t = {}, time.perf_counter()
        self.obj, self.mask = T.car(self._gen(4), *self.tr["car"], self.dev)
        self.weights = self._weights()
        self.sd = self.weights["model"]
        self._mark("weights")
        self.host_gen = torch.Generator().manual_seed(self.seed % (1 << 62))
        self.noise_gen = self._gen(5)
        self.drawer = self.R.HardeningTrainer(
            self.ref_cfg, torch.Generator().manual_seed(0), self.obj,
            self.mask, _NoTeacher(), device=self.dev,
            init_state_dict=self.sd)
        self.pool = [self._inputs(k) for k in range(self.tr["pool"])]
        self._mark("inputs")
        self.trainer, self.state = self._trainer(self.P, self.cfg)
        self._mark("trainer")
        self.recorded_draws = [self._draws() for _ in range(RECORDED)]
        self.record = self._drive(self.trainer, self.state,
                                  self.recorded_draws)
        self._mark("recorded steps")
        self.iterations: List[int] = []

    def _drive(self, trainer, state, draws, follow=None) -> dict:
        """The recorded steps on pool batches 0, 1, 2: each step's loss
        terms, the attack's textures and iterations, the first gradient
        as Adam holds it after step 1 and each parameter's change after
        the last. `follow`: textures that stand in for the attack's, one a
        step (the reference judging a record's steps)."""
        init = {f"{key}.{n}": v for key, sd in self.weights.items()
                for n, v in sd.items()}
        textures, iters, losses = [], [], []
        if self.harden:
            refresh = trainer.refresh_texture

            def capture(*a, **k):
                out = (refresh(*a, **k) if follow is None
                       else follow[len(textures)])
                textures.append(out.detach().clone())
                return out
            trainer.refresh_texture = capture
        try:
            for k in range(RECORDED):
                state, m = self._call(trainer, state, self.pool[k], draws[k])
                losses.append({n: v.detach().float() for n, v in m.items()})
                if self.harden and follow is None:
                    iters.append(trainer.attack.last_iterations)
                if k == 0:
                    params = _named_params(state)
                    grads = {n: state.optimizer.state[p]["exp_avg"]
                             / (1 - ADAM_BETA1)
                             for n, p in params.items()
                             if p in state.optimizer.state}
                    grad_norms = _norms(grads) if grads else {}
                    grad_vec = {n: g.detach().float().cpu()
                                for n, g in grads.items()}
            deltas = {n: (p - init[n]).detach().float()
                      for n, p in _named_params(state).items()}
            change = _norms(deltas)
            # on the host, so that the window's peak does not hold them
            change_vec = {n: d.cpu() for n, d in deltas.items()}
            del deltas
        finally:
            if self.harden:
                del trainer.refresh_texture
        return {"losses": [{n: float(v) for n, v in m.items()}
                           for m in losses],
                "grad": grad_norms, "grad_vec": grad_vec, "change": change,
                "change_vec": change_vec, "textures": textures,
                "iterations": iters}

    def step(self, i: int) -> None:
        k = (RECORDED + i) % len(self.pool)
        self.state, _ = self._call(self.trainer, self.state, self.pool[k],
                                   self._draws())
        if self.harden:
            self.iterations.append(self.trainer.attack.last_iterations)

    def layers(self) -> dict:
        if not self.harden:
            return {"layer:update": (self.trainer, "_update")}
        return {"layer:attack": (self.trainer, "refresh_texture"),
                "layer:synthesis": (self.trainer, "synth_batch"),
                "layer:update": (self.trainer, "_update")}

    def free(self) -> None:
        """Drop the program's state and all but the recorded batches."""
        del self.trainer, self.state
        self.pool = self.pool[:RECORDED]
        torch.cuda.empty_cache() if self.dev.type == "cuda" else None

    # -- the reference --------------------------------------------------------
    def _reference(self):
        return self._trainer(self.R, self.ref_cfg)

    def reference_record(self, judged: dict = None) -> dict:
        """The reference following the recorded steps of `judged` (default:
        the program's record) from the same weights, inputs and draws, in
        float32 with TF32 off. The attack is chaotic (one rounding moves
        the L0 loop's texture as far as another seed does), so the
        reference takes each step's texture from the record it judges,
        and checks the attack stage by itself: its own attack from the
        same start (step 1's weights, scene and draws), and the targeted
        cost that it reads at the judged texture, at its own and at the
        texture the attack starts from."""
        judged = judged or self.record
        trainer, state = self._reference()
        with self.R.float32():
            stage = self._attack_stage(trainer, state, judged) \
                if self.harden else {}
            rec = self._drive(trainer, state, self.recorded_draws,
                              judged["textures"] if self.harden else None)
        rec.update(stage)
        return rec

    def _attack_stage(self, trainer, state, judged) -> dict:
        draws = self.recorded_draws[0]
        scene = self.pool[0][3]
        own = trainer.refresh_texture(state, scene, draws)
        atk = trainer.attack_student(state)
        scenes = atk._replicate(scene, self.cfg.adv.attack_batch_size)
        z, a = draws.attack.z0s[0], draws.attack.alphas[0]
        start = start_texture(atk, draws.attack)
        texture = judged["textures"][0]
        with torch.no_grad():
            cost = [float(atk._objective(scenes, t, z, a))
                    for t in (texture, own, start)]
        return {"attack_cost": cost,
                "attack_moved": float((texture - start).abs().max()),
                "attack_iterations": trainer.attack.last_iterations}

    def control_record(self, control) -> dict:
        """The control's own record, made as the program's is: the
        reference in the program's place, in the precision `control(state)`
        gives."""
        trainer, state = self._reference()
        with control(state):
            return self._drive(trainer, state, self.recorded_draws)

    def readings(self, ref: dict, got: dict = None) -> Dict[str, float]:
        """The numbers compared, of `got` (default: the program's record)
        against the reference's record."""
        return train_readings(self.record if got is None else got, ref)


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=None,
               signed: bool = False):
    """Each leaf's gap between two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger; a leaf the
    program lacks reads its whole norm. `signed`: the program's norm
    minus the reference's, not its magnitude."""
    med = statistics.median(want.values())
    gap = (lambda d: d) if signed else abs
    return {k: gap(got.get(k, 0.0) - want[k]) / max(want[k], med)
            for k in want if keep is None or k in keep}


def _leaf_cos(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each leaf's 1 - cosine between the program's change and the
    reference's: 0 in the same direction, 2 reversed, 1 where either did
    not move."""
    out = {}
    for k in want:
        if k not in keep:
            continue
        a, b = got.get(k), want[k]
        if a is None:
            out[k] = 1.0
            continue
        a, b = a.double().flatten(), b.double().flatten()
        den = float(a.norm() * b.norm())
        out[k] = 1.0 - float(a @ b) / den if den > 0 else 1.0
    return out


def _descent(rec: dict, ref: dict, keep) -> Dict[str, float]:
    """Each leaf's inner product of `rec`'s change with the reference's
    first gradient: how far the update descends, to first order (a leaf
    the record lacks reads 0)."""
    out = {}
    for k in sorted(keep):
        g, d = ref["grad_vec"].get(k), rec["change_vec"].get(k)
        out[k] = 0.0 if g is None or d is None else \
            float(g.double().flatten() @ d.double().flatten())
    return out


def worst_leaves(rec: dict, ref: dict) -> Dict[str, str]:
    """The leaf that sets each worst-leaf gap (for the look behind a
    reading)."""
    out = {}
    for key in ("grad", "change"):
        gaps = _leaf_gaps(rec[key], ref[key])
        out[key] = max(gaps, key=gaps.get)
    return out


def train_readings(rec: dict, ref: dict) -> Dict[str, float]:
    """Each number of a record judged against the reference's: the
    losses' gaps relative to the reference (total and by branch;
    `loss_gap` the worst of the recorded steps, `loss_gap1` the first
    step's); the first gradient's worst-leaf and median-leaf norm gaps
    and the median leaf's signed gap (`shift`: a batch cut in half raises
    every leaf's norm at once); the parameters' change's worst-leaf and
    median-leaf norm gaps, and of the same leaves the worst and the
    median 1 - cosine of the change's direction (`change_cos`; without
    leaves whose reference gradient is under a thousandth of the median
    leaf's: Adam moves those by round-off); the change's first-order
    descent along the reference's first gradient against the reference's
    own (`descent_gap`: an update reversed reads about 2, one along
    gradients of another direction more than sound runs do) and along
    the record's own first gradient (`update_gap`: the optimizer's
    direction, whatever the gradient's); with an attack, its stage:
    the targeted cost at the judged texture against the cost at the
    reference's own (relative; `attack_start_gap` the same of the
    attack's starting texture, what an attack that hands back its start
    reads; `attack_gain_gap` the same gap over what the reference's own
    attack gained on its start, which such an attack reads as 1 on every
    seed, and a sound one above 1 on a seed where the reference's attack
    gains little), the judged first texture's largest distance from the
    attack's start (`attack_moved`) and whether it is the start
    (`attack_stayed`, 1 or 0: an attack that hands back its start reads 1
    on every seed), the first step's iterations against the reference's
    own, and the textures' range."""
    out = {}
    for name in ref["losses"][0]:
        gaps = [abs(p.get(name, float("nan")) - r[name])
                / max(abs(r[name]), 1e-30)
                for p, r in zip(rec["losses"], ref["losses"])]
        out[f"loss_gap.{name}"] = max(gaps)
        out[f"loss_gap1.{name}"] = gaps[0]
    grads = _leaf_gaps(rec["grad"], ref["grad"])
    out["grad_gap"] = max(grads.values())
    out["grad_gap.median"] = statistics.median(grads.values())
    out["grad_gap.shift"] = abs(statistics.median(
        _leaf_gaps(rec["grad"], ref["grad"], signed=True).values()))
    med = statistics.median(ref["grad"].values())
    moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    changes = _leaf_gaps(rec["change"], ref["change"], moved)
    out["change_gap"] = max(changes.values())
    out["change_gap.median"] = statistics.median(changes.values())
    cos = _leaf_cos(rec["change_vec"], ref["change_vec"], moved)
    out["change_cos"] = max(cos.values())
    out["change_cos.median"] = statistics.median(cos.values())
    cos = _leaf_cos(rec["grad_vec"], ref["grad_vec"], ref["grad_vec"])
    out["grad_cos"] = max(cos.values())
    out["grad_cos.median"] = statistics.median(cos.values())
    want = sum(_descent(ref, ref, moved).values())
    for name, grads in (("descent_gap", ref), ("update_gap", rec)):
        got = sum(_descent(rec, grads, moved).values())
        out[name] = abs(got - want) / max(abs(want), 1e-30)
    if "attack_cost" in ref:
        judged, own, start = ref["attack_cost"]
        out["attack_cost_gap"] = abs(judged - own) / max(abs(own), 1e-30)
        out["attack_start_gap"] = abs(start - own) / max(abs(own), 1e-30)
        out["attack_gain_gap"] = abs(judged - own) / max(abs(start - own),
                                                          1e-30)
        out["attack_moved"] = ref["attack_moved"]
        out["attack_stayed"] = float(ref["attack_moved"] <= STAYED)
        out["iterations_gap"] = float(abs(rec["iterations"][0]
                                          - ref["attack_iterations"]))
        out["texture_range"] = max(
            float(torch.clamp(-p, min=0).max() + torch.clamp(p - 1, min=0)
                  .max()) for p in rec["textures"])
    return out
