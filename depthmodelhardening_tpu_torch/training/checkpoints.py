"""Checkpoint save and restore, and the reference `.pth` files.

Counterpart of `depthmodelhardening_tpu/training/checkpoints.py:33-157`
(reference trainer.py:754-812, my_utils.py:107-125). The native format
is one `torch.save` file a step, `<ckpt_dir>/<step>/state.pt`, holding
the state dicts of every trained module (the student, the SimSiam head,
the pose networks: `TrainState.modules()`), the optimizer's state dict
(Adam's moments and counts), the step and, given the trainer, its
generators' states: the JAX CLI replays a resumed run's draws from
`PRNGKey(seed * 100003 + step)` (its `cli/main.py:416`), the port draws
from the trainer's generators, so a resumed run must carry them to draw
what the uninterrupted run would have drawn.

`export_reference_pth` / `load_reference_pth` write and read the
reference's `weights_<epoch>/{encoder,depth}.pth` (the encoder dict with
height, width and use_stereo), which the JAX package's
`load_reference_pth` reads too; `export_manydepth_reference` /
`load_manydepth_reference` write and read a ManyDepth weights folder (the
encoder regrouped as the reference's, with its depth bins). `save_options` writes
the JAX package's `opt.json`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.convert import (
    METADATA_KEYS, load_reference_state_dict, to_reference_matching_encoder,
)

STATE_FILE = "state.pt"
# the JAX package's TPU layout options, which the port does not have (it
# runs the plain layout): opt.json records them off, before "fold_bn", as
# the JAX package's configs order them
TPU_LAYOUT_OPTIONS = ("s2d_stem", "wpack_stem", "wpack_stem8", "fuse_upconv",
                      "packed_decoder", "wpack_decoder")


def _generators(trainer) -> Dict[str, torch.Generator]:
    return {"generator": trainer.generator,
            "noise_generator": trainer.noise_generator}


def save_state(ckpt_dir: str, step: int, state, keep: int = 5,
               trainer=None) -> str:
    """Save a `HardeningTrainer`'s `TrainState` under <ckpt_dir>/<step>,
    with `trainer`'s generator states when given; keep the `keep` latest
    steps. Returns the directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), str(step))
    os.makedirs(path, exist_ok=True)
    payload = {"modules": {k: m.state_dict()
                           for k, m in state.modules().items()},
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    if trainer is not None:
        payload["generators"] = {k: g.get_state()
                                 for k, g in _generators(trainer).items()}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    _prune(ckpt_dir, keep)
    return path


def restore_state(ckpt_dir: str, state_like, step: Optional[int] = None,
                  trainer=None):
    """Load the checkpoint of `step` (None: the latest) into `state_like`
    (a state of the same configuration, e.g. `trainer.make_state()`) in
    place, and `trainer`'s generators when given. Returns the state."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    payload = torch.load(os.path.join(os.path.abspath(ckpt_dir), str(step),
                                      STATE_FILE),
                         map_location="cpu", weights_only=True)
    modules = state_like.modules()
    if set(modules) != set(payload["modules"]):
        raise ValueError(f"the checkpoint holds {sorted(payload['modules'])}"
                         f", the state {sorted(modules)}")
    for key, module in modules.items():
        module.load_state_dict(payload["modules"][key])
    state_like.optimizer.load_state_dict(payload["optimizer"])
    state_like.step = payload["step"]
    if trainer is not None:
        saved = payload.get("generators")
        if saved is None:
            raise ValueError("the checkpoint holds no generator states")
        for key, gen in _generators(trainer).items():
            gen.set_state(saved[key])
    return state_like


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)


def _options(cfg) -> dict:
    """The options snapshot of a config dataclass, as the JAX package's
    `save_options` writes it: the fields in order, with the JAX package's
    TPU layout options off."""
    out = {}
    for key, value in dataclasses.asdict(cfg).items():
        if key == "fold_bn":
            out.update({k: False for k in TPU_LAYOUT_OPTIONS})
        out[key] = value
    return out


def save_options(log_dir: str, cfg) -> None:
    """Options snapshot (trainer.py:754-763 save_opts -> opt.json)."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "opt.json"), "w") as f:
        json.dump(_options(cfg), f, indent=2, default=str)


def export_reference_pth(save_dir: str, epoch, state_dict,
                         height: int = 320, width: int = 1024,
                         use_stereo: bool = True) -> str:
    """Write reference-compatible weights_<epoch>/{encoder,depth}.pth from
    a MonodepthModel state dict (my_utils.py:107-125: the encoder dict
    gains height, width and use_stereo). Returns the folder."""
    folder = os.path.join(save_dir, f"weights_{epoch}")
    os.makedirs(folder, exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    enc = {k: v for k, v in cpu.items() if k.startswith("encoder.")}
    enc.update(height=height, width=width, use_stereo=use_stereo)
    dec = {k[len("decoder."):]: v for k, v in cpu.items()
           if k.startswith("decoder.")}
    torch.save(enc, os.path.join(folder, "encoder.pth"))
    torch.save(dec, os.path.join(folder, "depth.pth"))
    return folder


def export_manydepth_reference(save_dir: str, epoch, state_dict,
                               height: int = 192, width: int = 640,
                               min_depth_bin: float = 0.1,
                               max_depth_bin: float = 20.0) -> str:
    """Write a ManyDepth weights_<epoch>/{encoder,depth}.pth from a
    ManyDepthModel / ManyDepthTrainModel state dict: the encoder in the
    reference's Sequential layout (`to_reference_matching_encoder`) with
    height, width, use_stereo (False) and the depth bins, the decoder's
    ModuleList (manydepth2/trainer.py save_model). Returns the folder."""
    folder = os.path.join(save_dir, f"weights_{epoch}")
    os.makedirs(folder, exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    enc = to_reference_matching_encoder(cpu)
    enc.update(height=height, width=width, use_stereo=False,
               min_depth_bin=min_depth_bin, max_depth_bin=max_depth_bin)
    dec = {k[len("decoder."):]: v for k, v in cpu.items()
           if k.startswith("decoder.")}
    torch.save(enc, os.path.join(folder, "encoder.pth"))
    torch.save(dec, os.path.join(folder, "depth.pth"))
    return folder


def load_reference_pth(weights_folder: str
                       ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Reference weights_*/encoder.pth + depth.pth -> (the MonodepthModel
    state dict, the encoder's metadata: height, width, use_stereo where
    present) (depth_model.py:89-161)."""
    load = lambda name: torch.load(os.path.join(weights_folder, name),
                                   map_location="cpu", weights_only=True)
    enc, dec = load("encoder.pth"), load("depth.pth")
    meta = {k: v for k, v in enc.items() if k in METADATA_KEYS}
    return load_reference_state_dict(enc, dec), meta


def load_manydepth_reference(weights_folder: str, height: int = 192,
                             width: int = 640, device=None):
    """A ManyDepth weights folder (`encoder.pth` with the Sequential
    layer0 / layer1 regrouping and its metadata: height, width,
    min_depth_bin, max_depth_bin, ...; `depth.pth`) -> (a ManyDepthModel
    in eval mode with those weights, at the metadata's height and width
    where present, else `height` and `width`, on `device` (default the
    card, `resolve_device`); the metadata) (depth_model.py:108-134; JAX
    `load_manydepth_reference`). The depth bins go to the model's calls:
    `model(x, K, invK, meta["min_depth_bin"], meta["max_depth_bin"])`.
    The metadata's `depth_binning` ("linear" where absent, or "inverse")
    is the model's; JAX's loader reads it and bins linearly whatever it
    says."""
    from ..models.wrappers import ManyDepthModel

    load = lambda name: torch.load(os.path.join(weights_folder, name),
                                   map_location="cpu", weights_only=True)
    enc, dec = load("encoder.pth"), load("depth.pth")
    meta = {k: v for k, v in enc.items() if k in METADATA_KEYS}
    model = ManyDepthModel(input_height=int(meta.get("height", height)),
                           input_width=int(meta.get("width", width)),
                           depth_binning=meta.get("depth_binning", "linear"))
    model.load_state_dict(load_reference_state_dict(enc, dec,
                                                    kind="manydepth"))
    return model.to(resolve_device(device)).eval(), meta
