"""Weights into the port's MonodepthModel state dict.

(a) `from_jax_variables`: the JAX package's flax variables of a
    MonodepthModel, as a tree of numpy arrays (HWIO kernels, BatchNorm
    scale/bias/mean/var, decoder modules named as in
    `depthmodelhardening_tpu/models/depth_decoder.py:374`); a tree of
    gradients, {"params": grads}, converts the same way.
    `from_jax_train_state` takes the JAX trainer's collections
    ({"params": {"depth": ...}, "batch_stats": {"depth": ...}});
    `from_jax_distill_state` a JAX `DistillState` with its Adam moments.
    A JAX `HardeningTrainer`'s contrastive head, the `simsiam`
    collection, converts with `from_jax_simsiam` (Dense kernels
    transposed; BatchNorm scale/bias/mean/var); `from_jax_hardening_state`
    takes the whole JAX trainer state: student, head, Adam moments, step.
(b) `load_reference_state_dict`: the reference checkpoints'
    `encoder.pth` / `depth.pth` key layout ("encoder."-prefixed
    torchvision trunk with fc head and metadata keys; "decoder.<idx>"
    ModuleList), which is the port's own naming
    (cf. `depthmodelhardening_tpu/models/torch_import.py:67-130`).

Both return a state dict for `model.load_state_dict(..., strict=True)`.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .depth_decoder import decoder_module_names

_METADATA_KEYS = {"height", "width", "use_stereo", "min_depth_bin",
                  "max_depth_bin"}


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


def from_jax_variables(variables: Mapping,
                       scales: Sequence[int] = (0, 1, 2, 3)
                       ) -> Dict[str, torch.Tensor]:
    """flax MonodepthModel variables {"params": {"encoder", "decoder"},
    "batch_stats": {"encoder"}} -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    enc_params = _flatten(variables["params"]["encoder"])
    enc_stats = _flatten(variables.get("batch_stats", {}).get("encoder", {}))
    for path, v in enc_params.items():
        mod = "encoder." + _encoder_module_path(path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            sd[f"{mod}.weight"] = _kernel(v)
        elif leaf == "scale":
            sd[f"{mod}.weight"] = _t(v)
        else:
            sd[f"{mod}.{leaf}"] = _t(v)
    for path, v in enc_stats.items():
        mod = "encoder." + _encoder_module_path(path[:-1])
        sd[f"{mod}.running_{path[-1]}"] = _t(v)
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)

    index = {n: i for i, n in enumerate(decoder_module_names(scales))}
    for path, v in _flatten(variables["params"]["decoder"]).items():
        # upconv_i_j/conv/conv/{kernel,bias}: ConvBlock -> Conv3x3 -> Conv2d
        # dispconv_s/conv/{kernel,bias}: Conv3x3 -> Conv2d
        inner = ".".join(["conv"] * (len(path) - 2))
        leaf = "weight" if path[-1] == "kernel" else "bias"
        key = f"decoder.decoder.{index[path[0]]}.{inner}.{leaf}"
        sd[key] = _kernel(v) if leaf == "weight" else _t(v)
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


def from_jax_hardening_state(state, scales: Sequence[int] = (0, 1, 2, 3)
                             ) -> Dict[str, object]:
    """A JAX `HardeningTrainer` state (params and batch_stats keyed by
    collection, "depth" and, with the contrastive branch, "simsiam";
    `optax.adam`'s opt_state; step; arrays or numpy) -> {"model": the
    student's state dict, "simsiam": the head's (or None), "adam":
    {"model": {parameter name: torch.optim.Adam state}, "simsiam":
    {...}}, "step": int}, for `HardeningTrainer.make_state(resume=...)`."""
    adam = state.opt_state[0]  # optax.adam = chain(scale_by_adam, lr)
    out = {"model": from_jax_variables(
        {"params": state.params["depth"],
         "batch_stats": state.batch_stats["depth"]}, scales),
        "simsiam": None, "adam": {}, "step": int(np.asarray(state.step))}
    out["adam"]["model"] = _adam_state(
        adam, from_jax_variables({"params": adam.mu["depth"]}, scales),
        from_jax_variables({"params": adam.nu["depth"]}, scales))
    if "simsiam" in state.params:
        out["simsiam"] = from_jax_simsiam(
            {"params": state.params["simsiam"],
             "batch_stats": state.batch_stats["simsiam"]})
        out["adam"]["simsiam"] = _adam_state(
            adam, from_jax_simsiam({"params": adam.mu["simsiam"]}),
            from_jax_simsiam({"params": adam.nu["simsiam"]}))
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


def load_reference_state_dict(encoder_sd: Mapping, decoder_sd: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """Reference `encoder.pth` + `depth.pth` dicts -> the port's state
    dict. Drops the classifier head and the metadata keys."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in encoder_sd.items():
        if key in _METADATA_KEYS:
            continue
        name = key[len("encoder."):] if key.startswith("encoder.") else key
        if name.startswith("fc."):
            continue
        sd["encoder." + name] = _t(v)
    for key, v in decoder_sd.items():
        if not key.startswith("decoder."):
            raise KeyError(f"unexpected depth decoder key {key!r}")
        sd["decoder." + key] = _t(v)
    return sd
