"""Evaluation cells: the object attack's evaluation, batch after batch.

Each window step is one call of the program's `evaluate_attacks` on one
distinct pool batch of scenes with the benchmark's draws, as the
`eval-attacks` path runs a batch: the attack, its finals and the depth
metrics of the attacked scenes against the benign ones. Each batch's
answer (its metrics and its texture) is kept; once the window has
closed, the plain reference attacks a seeded sample of the window's
batches from the same weights, scenes and draws, and `readings` compares
the answers.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict

import torch

from . import traffic as T
from .faults import start_texture
from .train import TrainCell

WARMUP = 2
SAMPLED = 4
METRICS = ("abs_err", "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2",
           "a3")


class _OnDevice:
    """What an attack asks of its predictor to draw: the device."""

    def __init__(self, device):
        self.device = device


class _Attack:
    """The program's attack as `evaluate_attacks` calls it, keeping each
    call's texture; `attack_call` is the range the traced run wraps."""

    def __init__(self, attack):
        self.attack = attack
        self.textures = []
        self.attack_call = attack

    def __call__(self, *args, **kwargs):
        adv, ben, masks, obj_adv = self.attack_call(*args, **kwargs)
        self.textures.append(obj_adv.detach().clone())
        return adv, ben, masks, obj_adv


class EvalCell(TrainCell):
    kind = "eval"

    def __init__(self, spec, seed, dev, port, reference):
        self.spec, self.seed, self.dev = spec, seed, dev
        self.P, self.R = port, reference
        self.tr = tr = spec["traffic"]
        cfg = spec["config"]
        self.eval_cfg = port.attack_eval.AttackEvalConfig(
            scene_h=cfg["height"], scene_w=cfg["width"], ori_h=tr["scene"][0],
            ori_w=tr["scene"][1], eval_count=1, **tr["attack"])
        self.ref_cfg = dataclasses.replace(
            reference.config.HardeningConfig(), num_layers=cfg["num_layers"],
            contrastive_learning=False, selfsup=reference.config.SelfSupConfig(
                height=cfg["height"], width=cfg["width"]))
        self.batch = self.images_per_step = self.eval_cfg.batch_size
        self.answers = []

    def _ref_attack(self, predictor):
        """The reference's attack, built as the program's `build_attack`
        builds an "l_inf" one."""
        c, R = self.eval_cfg, self.R
        veh_h, veh_w = R.VEHICLE_SIZES[next(
            (k for k in R.VEHICLE_SIZES if c.obj_name.startswith(k)), "BMW")]
        base = R.PhysObjAttackConfig(
            obj_h=self.obj.shape[1], obj_w=self.obj.shape[2],
            scene_h=c.scene_h, scene_w=c.scene_w, ori_h=c.ori_h,
            ori_w=c.ori_w, veh_h=veh_h, veh_w=veh_w, eval_pin_z0=7.0)
        return R.PGDObjectAttack(predictor, self.obj, self.mask, base,
                                 eps=c.epsilon, alpha=c.alpha, steps=c.step)

    def _model(self, mod):
        model = mod.make_monodepth2(self.spec["config"]["num_layers"])
        model.load_state_dict(self.sd)
        return mod.predictor_from(model.to(self.dev))

    def setup(self) -> None:
        c = self.eval_cfg
        if c.norm_type != "l_inf":
            raise ValueError("the evaluation cell drives the l_inf attack")
        self.setup_parts, self._t = {}, time.perf_counter()
        self.obj, self.mask = T.car(self._gen(4), *self.tr["car"], self.dev)
        self.sd = self._weights()["model"]
        self._mark("weights")
        self.host_gen = torch.Generator().manual_seed(self.seed % (1 << 62))
        self.drawer = self._ref_attack(_OnDevice(self.dev))
        h, w = self.tr["scene"]
        self.pool = [T.scenes(self._gen(100 + k), self.batch, h, w, self.dev)
                     for k in range(self.tr["pool"])]
        self.predictor = self._model(self.P)
        self.attack = _Attack(self.P.attack_eval.build_attack(
            c, self.predictor, self.obj, self.mask))
        self.draws = []
        self._mark("inputs and attack")
        for i in range(WARMUP):
            self.step(-WARMUP + i)
        self._mark("warm-up batches")
        self.answers, self.draws, self.attack.textures = [], [], []

    def step(self, i: int) -> None:
        k = i % len(self.pool)
        d = self.drawer.draw(self.host_gen, self.batch)
        self.draws.append((k, d))
        res = self.P.attack_eval.evaluate_attacks(
            self.predictor, self.attack, [self.pool[k]], self.eval_cfg,
            draws=[d])
        self.answers.append(res["mean"])

    def layers(self) -> dict:
        return {"layer:attack": (self.attack, "attack_call"),
                "layer:metrics": (self.P.attack_eval, "_batch_metrics")}

    def free(self) -> None:
        self.textures = self.attack.textures
        del self.predictor, self.attack
        torch.cuda.empty_cache() if self.dev.type == "cuda" else None

    # -- the reference --------------------------------------------------------
    def sample(self):
        """The window's batches the reference checks: a sample drawn from
        the seed, the last batch always in it."""
        n = len(self.answers)
        rng = random.Random(self.seed)
        picked = set(rng.sample(range(n), min(SAMPLED - 1, n)))
        return sorted(picked | {n - 1})

    def _answer(self, predictor, attack, i, texture=None):
        """Batch i's answer as the reference computes it: (texture,
        metrics) of its own attack, or of `texture` put through the same
        finals and metrics."""
        k, d = self.draws[i]
        scenes = attack._replicate(self.pool[k], self.batch)
        if texture is None:
            texture = attack._optimize(scenes, d)
        with torch.no_grad():
            adv, ben, masks = attack._final_outputs(
                scenes, texture, d.final_z0s, d.final_alphas, True)
            errs = self.R.compute_errors_masked(
                self.R.scaled_clamped_depth(predictor(ben)),
                self.R.scaled_clamped_depth(predictor(adv)), masks)
        return texture.detach(), dict(zip(METRICS,
                                          torch.stack(errs).cpu().tolist()))

    def reference_record(self, judged: dict = None) -> dict:
        """The reference's answers at the sampled batches, in float32 with
        TF32 off, from the judged textures (default: the program's): the
        attack is chaotic (PGD's signs flip on a rounding), so the finals
        and metrics are recomputed from the texture judged, and the
        attack stage is checked by itself: the reference's own attack on
        the same scenes and draws, and the targeted cost it reads at the
        judged texture, at its own and at the attack's start."""
        index = judged["index"] if judged else self.sample()
        textures = judged["textures"] if judged else \
            [self.textures[i] for i in index]
        predictor = self._model(self.R)
        attack = self._ref_attack(predictor)
        out = {"index": index, "answers": [], "attack_cost": []}
        with self.R.float32():
            for i, tex in zip(index, textures):
                out["answers"].append(self._answer(predictor, attack, i,
                                                   tex)[1])
                own, _ = self._answer(predictor, attack, i)
                k, d = self.draws[i]
                scenes = attack._replicate(self.pool[k], self.batch)
                start = start_texture(attack, d)
                with torch.no_grad():
                    out["attack_cost"].append([float(attack._objective(
                        scenes, t, d.z0s[0], d.alphas[0]))
                        for t in (tex, own, start)])
        return out

    def control_record(self, control) -> dict:
        """The control's own answers at the sampled batches: the reference
        in the program's place, in the precision `control(model)` gives."""
        predictor = self._model(self.R)
        attack = self._ref_attack(predictor)
        out = {"index": self.sample(), "answers": [], "textures": []}
        with control(predictor.model):
            for i in out["index"]:
                tex, answer = self._answer(predictor, attack, i)
                out["textures"].append(tex)
                out["answers"].append(answer)
        return out

    def readings(self, ref: dict, got: dict = None) -> Dict[str, float]:
        """The numbers compared, of `got` (default: the program's answers
        at the reference's sample) against the reference's record: the
        sampled batches' metrics' worst gap (relative to the reference's
        value, floored at 1e-6), the worst gap of the targeted cost at the
        judged texture to the cost at the reference's own (relative;
        `attack_start_gap` the same of the attack's start;
        `attack_gain_gap` the gap over what the reference's own attack
        gained on its start), and
        how far the textures (the program's: every one of the window)
        leave the eps ball."""
        if got is None:
            got = {"answers": [self.answers[i] for i in ref["index"]],
                   "textures": [self.textures[i] for i in ref["index"]],
                   "all_textures": self.textures}
        out = {"metric_gap": max(
            abs(g[m] - r[m]) / max(abs(r[m]), 1e-6)
            for g, r in zip(got["answers"], ref["answers"]) for m in METRICS)}
        out["attack_cost_gap"] = max(abs(j - o) / max(abs(o), 1e-30)
                                     for j, o, _ in ref["attack_cost"])
        out["attack_start_gap"] = max(abs(s - o) / max(abs(o), 1e-30)
                                      for _, o, s in ref["attack_cost"])
        out["attack_gain_gap"] = max(abs(j - o) / max(abs(s - o), 1e-30)
                                     for j, o, s in ref["attack_cost"])
        out["texture_eps"] = max(
            float((t - self.obj).abs().max())
            for t in got.get("all_textures", got["textures"])) \
            - self.eval_cfg.epsilon
        return out
