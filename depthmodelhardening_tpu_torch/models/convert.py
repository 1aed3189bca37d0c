"""Weights into the port's state dicts.

(a) `from_jax_variables`: the JAX package's flax variables of a
    MonodepthModel or a ManyDepth model, as a tree of numpy arrays (HWIO
    kernels, BatchNorm scale/bias/mean/var, decoder modules named as in
    `depthmodelhardening_tpu/models/depth_decoder.py:374`; the encoder's
    scopes are torchvision's names with "_" for ".", so a Bottleneck's
    `layer{i}_{b}/conv3`, `bn3`, `downsample_0/1` and the matching
    encoder's `reduce_conv` and `prematching_conv` convert like the
    rest); a tree of gradients, {"params": grads}, converts the same way.
    `from_jax_train_state` takes the JAX trainer's collections
    ({"params": {"depth": ...}, "batch_stats": {"depth": ...}});
    `from_jax_distill_state` a JAX `DistillState` with its Adam moments.
    A JAX `HardeningTrainer`'s other collections convert with
    `from_jax_simsiam` (the contrastive head: Dense kernels transposed,
    BatchNorm scale/bias/mean/var), `from_jax_encoder` (the pose
    encoder, a bare ResNet trunk) and `from_jax_convs` (the pose
    decoder; PoseCNN); `from_jax_hardening_state` takes the whole JAX
    trainer state: student, heads, pose nets, Adam moments, step.
(b) `load_reference_state_dict`: the reference checkpoints' layouts
    (`encoder.pth` + `depth.pth`, which is the port's own naming;
    `pose_encoder.pth`, `pose.pth`, PoseCNN's and SimSiam's, and
    ManyDepth's `encoder.pth` with its Sequential regrouping, renamed to
    the port's module names; cf. `depthmodelhardening_tpu/models/
    torch_import.py:67-190, 281-334`).

All return a state dict for `module.load_state_dict(..., strict=True)`.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .depth_decoder import decoder_module_names

METADATA_KEYS = {"height", "width", "use_stereo", "min_depth_bin",
                 "max_depth_bin", "depth_binning"}


def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    return torch.from_numpy(np.array(v, copy=True))


def _kernel(v) -> torch.Tensor:
    """flax HWIO kernel -> torch OIHW weight."""
    return _t(np.transpose(np.asarray(v), (3, 2, 0, 1)))


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _encoder_module_path(scope: Sequence[str]) -> str:
    """("layer2_0", "downsample_1") -> "layer2.0.downsample.1"."""
    parts = []
    for s in scope:
        m = re.fullmatch(r"(layer\d+|downsample)_(\d+)", s)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else s)
    return ".".join(parts)


def _encoder_sd(params: Mapping, stats: Mapping, prefix: str
                ) -> Dict[str, torch.Tensor]:
    """flax ResnetEncoder params and batch_stats -> torchvision-named
    entries under `prefix`."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        mod = prefix + _encoder_module_path(path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            sd[f"{mod}.weight"] = _kernel(v)
        elif leaf == "scale":
            sd[f"{mod}.weight"] = _t(v)
        else:
            sd[f"{mod}.{leaf}"] = _t(v)
    for path, v in _flatten(stats).items():
        mod = prefix + _encoder_module_path(path[:-1])
        sd[f"{mod}.running_{path[-1]}"] = _t(v)
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd


def from_jax_variables(variables: Mapping,
                       scales: Sequence[int] = (0, 1, 2, 3)
                       ) -> Dict[str, torch.Tensor]:
    """flax MonodepthModel variables {"params": {"encoder", "decoder"},
    "batch_stats": {"encoder"}} -> the port's state dict."""
    sd = _encoder_sd(variables["params"]["encoder"],
                     variables.get("batch_stats", {}).get("encoder", {}),
                     "encoder.")
    index = {n: i for i, n in enumerate(decoder_module_names(scales))}
    for path, v in _flatten(variables["params"]["decoder"]).items():
        # upconv_i_j/conv/conv/{kernel,bias}: ConvBlock -> Conv3x3 -> Conv2d
        # dispconv_s/conv/{kernel,bias}: Conv3x3 -> Conv2d
        inner = ".".join(["conv"] * (len(path) - 2))
        leaf = "weight" if path[-1] == "kernel" else "bias"
        key = f"decoder.decoder.{index[path[0]]}.{inner}.{leaf}"
        sd[key] = _kernel(v) if leaf == "weight" else _t(v)
    return sd


def from_jax_encoder(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ResnetEncoder variables {"params", "batch_stats"} (or
    {"params": grads}) -> the state dict of the port's bare
    `models/resnet.py:ResnetEncoder` (the pose encoder's: its 6-channel
    stem converts as any other conv)."""
    return _encoder_sd(variables["params"],
                       variables.get("batch_stats", {}), "")


def from_jax_convs(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of modules made of named Convs, {"params": {name:
    {"kernel", "bias"}}} (or gradients) -> the state dict of the port's
    module of the same names: `models/pose.py`'s PoseDecoder and
    PoseCNN."""
    sd: Dict[str, torch.Tensor] = {}
    for (mod, leaf), v in _flatten(variables["params"]).items():
        sd[f"{mod}.{'weight' if leaf == 'kernel' else leaf}"] = (
            _kernel(v) if leaf == "kernel" else _t(v))
    return sd


def from_jax_train_state(variables: Mapping,
                         scales: Sequence[int] = (0, 1, 2, 3)
                         ) -> Dict[str, torch.Tensor]:
    """The student of a JAX `HardeningTrainer` state, {"params": {"depth":
    ...}, "batch_stats": {"depth": ...}} as numpy, -> the port's state
    dict."""
    return from_jax_variables(
        {"params": variables["params"]["depth"],
         "batch_stats": variables["batch_stats"]["depth"]}, scales)


def from_jax_simsiam(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax SimSiam variables {"params": {...}, "batch_stats": {...}} (or
    a tree of gradients, {"params": grads}) -> the state dict of the
    port's `models/simsiam.py:SimSiam`: module names as flax's, Dense
    kernels (in, out) -> Linear weights (out, in), BatchNorm scale ->
    weight."""
    sd: Dict[str, torch.Tensor] = {}
    for (mod, leaf), v in _flatten(variables["params"]).items():
        if leaf == "kernel":
            sd[f"{mod}.weight"] = _t(np.asarray(v).T)
        else:
            sd[f"{mod}.{'weight' if leaf == 'scale' else leaf}"] = _t(v)
    for (mod, leaf), v in _flatten(variables.get("batch_stats", {})).items():
        sd[f"{mod}.running_{leaf}"] = _t(v)
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _adam_state(adam, mu: Mapping, nu: Mapping):
    """optax's moments (converted) -> {parameter name: torch.optim.Adam
    state}. optax keeps one step count for all parameters, torch one per
    parameter: each gets the count."""
    count = torch.tensor(float(np.asarray(adam.count)))
    return {name: {"step": count.clone(), "exp_avg": mu[name],
                   "exp_avg_sq": nu[name]} for name in mu}


# the JAX trainer's collections -> (the port's key, converter of a
# collection's variables or of a tree of its gradients or moments)
_COLLECTIONS = {
    "simsiam": ("simsiam", lambda v: from_jax_simsiam(v)),
    "pose_encoder": ("pose_encoder", lambda v: from_jax_encoder(v)),
    "pose_decoder": ("pose_decoder", lambda v: from_jax_convs(v)),
}


def from_jax_hardening_state(state, scales: Sequence[int] = (0, 1, 2, 3)
                             ) -> Dict[str, object]:
    """A JAX `HardeningTrainer` state (params and batch_stats keyed by
    collection: "depth", with the contrastive branch "simsiam", with
    temporal frame ids "pose_encoder" and "pose_decoder"; `optax.adam`'s
    opt_state; step; arrays or numpy) -> {"model": the student's state
    dict, "simsiam", "pose_encoder", "pose_decoder": the heads' (None
    where absent), "adam": {the same keys: {parameter name:
    torch.optim.Adam state}}, "step": int}, for
    `HardeningTrainer.make_state(resume=...)`."""
    adam = state.opt_state[0]  # optax.adam = chain(scale_by_adam, lr)
    out = {"model": from_jax_variables(
        {"params": state.params["depth"],
         "batch_stats": state.batch_stats["depth"]}, scales),
        "adam": {}, "step": int(np.asarray(state.step))}
    out["adam"]["model"] = _adam_state(
        adam, from_jax_variables({"params": adam.mu["depth"]}, scales),
        from_jax_variables({"params": adam.nu["depth"]}, scales))
    for coll, (key, convert) in _COLLECTIONS.items():
        out[key] = None
        if coll not in state.params:
            continue
        out[key] = convert({"params": state.params[coll],
                            "batch_stats": state.batch_stats.get(coll, {})})
        out["adam"][key] = _adam_state(
            adam, convert({"params": adam.mu[coll]}),
            convert({"params": adam.nu[coll]}))
    return out


def from_jax_distill_state(state, scales: Sequence[int] = (0, 1, 2, 3)
                           ) -> Dict[str, object]:
    """A JAX `DistillState` (params, batch_stats, `optax.adam`'s opt_state
    and step; arrays or numpy) -> {"model": the port's state dict,
    "adam": {parameter name: torch.optim.Adam state}, "step": int}, for
    `DistillTrainer.make_state(resume=...)`."""
    adam = state.opt_state[0]  # optax.adam = chain(scale_by_adam, lr)
    return {
        "model": from_jax_variables({"params": state.params,
                                     "batch_stats": state.batch_stats},
                                    scales),
        "adam": _adam_state(
            adam, from_jax_variables({"params": adam.mu}, scales),
            from_jax_variables({"params": adam.nu}, scales)),
        "step": int(np.asarray(state.step)),
    }


def _reference_encoder(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A reference `encoder.pth` / `pose_encoder.pth` dict -> entries
    under `prefix`, less the classifier head and the metadata keys."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if key in METADATA_KEYS:
            continue
        name = key[len("encoder."):] if key.startswith("encoder.") else key
        if not name.startswith("fc."):
            out[prefix + name] = _t(v)
    return out


def _renamed(sd: Mapping, rename) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        new = rename(key)
        if new is None:
            raise KeyError(f"unexpected reference key {key!r}")
        out[new] = _t(v)
    return out


def _sub(pattern: str, repl):
    return lambda key: (re.sub(pattern, repl, key, count=1)
                        if re.match(pattern, key) else None)


# the reference PoseDecoder's `net` ModuleList order (pose_decoder.py:25-33)
_POSE_NET = ("squeeze", "pose_0", "pose_1", "pose_2")
REFERENCE_KINDS = ("depth", "manydepth", "pose_encoder", "pose",
                   "pose_cnn", "simsiam")


def _matching_name(key: str):
    """A ManyDepth `encoder.pth` key -> the port's ResnetEncoderMatching
    name, or None for a key the JAX converter skips
    (`convert_matching_encoder`): layer0.0 = conv1, layer0.1 = bn1,
    layer1.1.<b> = layer1.<b> (layer1.0 is the pool), layer2-4 as they
    are, prematching_conv.0 / reduce_conv.0 (Sequential(conv, relu)) ->
    prematching_conv / reduce_conv."""
    name = key[len("encoder."):] if key.startswith("encoder.") else key
    for pattern, repl in ((r"layer0\.0\.", "conv1."), (r"layer0\.1\.", "bn1."),
                          (r"layer1\.1\.", "layer1."),
                          (r"layer([234])\.", r"layer\1."),
                          (r"(prematching_conv|reduce_conv)\.0\.", r"\1.")):
        if re.match(pattern, name):
            return re.sub(pattern, repl, name, count=1)
    return None


# the port's ResnetEncoderMatching names -> the reference's: the inverse
# of `_matching_name`
_MATCHING_TO_REFERENCE = ((r"conv1\.", "layer0.0."), (r"bn1\.", "layer0.1."),
                          (r"layer1\.", "layer1.1."),
                          (r"(prematching_conv|reduce_conv)\.", r"\1.0."))


def to_reference_matching_encoder(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The "encoder." tensors of a ManyDepthModel / ManyDepthTrainModel
    state dict -> ManyDepth's `encoder.pth` keys (layer0.0 = conv1,
    layer0.1 = bn1, layer1.1.<b> = layer1.<b>, prematching_conv.0 /
    reduce_conv.0; layer2-4 as they are), without the metadata."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if not key.startswith("encoder."):
            continue
        name = key[len("encoder."):]
        for pattern, repl in _MATCHING_TO_REFERENCE:
            if re.match(pattern, name):
                name = re.sub(pattern, repl, name, count=1)
                break
        out[name] = v
    return out


def _reference_matching_encoder(sd: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        name = None if key in METADATA_KEYS else _matching_name(key)
        if name is not None:
            out["encoder." + name] = _t(v)
    return out


def load_reference_state_dict(sd: Mapping, decoder_sd: Mapping = None,
                              kind: str = "depth"
                              ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict -> the state dict of the
    port's module of `kind` (cf. `depthmodelhardening_tpu/models/
    torch_import.py:67-190`):

    * "depth": `encoder.pth` (sd) + `depth.pth` (decoder_sd) ->
      MonodepthModel: the "encoder."-prefixed torchvision trunk (the
      classifier head and the metadata keys dropped; ResNet-18 to 152)
      and the "decoder.<idx>" ModuleList, the port's own naming;
    * "manydepth": ManyDepth's `encoder.pth` + `depth.pth` ->
      ManyDepthModel / ManyDepthTrainModel: the regrouped trunk
      (`_matching_name`; metadata keys and any other key dropped, as the
      JAX converter drops them) and the decoder as "depth"'s;
    * "pose_encoder": `pose_encoder.pth` -> ResnetEncoder(
      num_input_images=2) (its conv1 takes 6 channels);
    * "pose": `pose.pth` -> PoseDecoder (`net.<i>`: squeeze, pose_0,
      pose_1, pose_2);
    * "pose_cnn": PoseCNN's (`net.<i>` -> convs_<i>, `pose_conv`);
    * "simsiam": the contrastive head's (`projector.<i>` /
      `predictor.<i>` Sequentials, BatchNorm1d at projector 1, 4, 7 and
      predictor 1) -> SimSiam's `projector_<i>` / `predictor_<i>`.
    """
    if kind in ("depth", "manydepth"):
        if decoder_sd is None:
            raise ValueError(f"kind {kind!r} needs depth.pth as decoder_sd")
        out = (_reference_encoder(sd, "encoder.") if kind == "depth"
               else _reference_matching_encoder(sd))
        out.update(_renamed(decoder_sd, _sub(r"decoder\.", "decoder.decoder.")))
        return out
    if decoder_sd is not None:
        raise ValueError(f"kind {kind!r} reads one state dict")
    if kind == "pose_encoder":
        return _reference_encoder(sd, "")
    if kind == "pose":
        return _renamed(sd, _sub(r"net\.(\d+)\.",
                                 lambda m: f"{_POSE_NET[int(m[1])]}."))
    if kind == "pose_cnn":
        return _renamed(sd, lambda k: (_sub(r"net\.(\d+)\.", r"convs_\1.")(k)
                                       or _sub(r"pose_conv\.", "pose_conv.")(k)))
    if kind == "simsiam":
        return _renamed(sd, _sub(r"(projector|predictor)\.(\d+)\.", r"\1_\2."))
    raise ValueError(f"unknown reference kind {kind!r}; one of "
                     f"{REFERENCE_KINDS}")
