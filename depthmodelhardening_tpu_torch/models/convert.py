"""Weights into the port's MonodepthModel state dict.

(a) `from_jax_variables`: the JAX package's flax variables of a
    MonodepthModel, as a tree of numpy arrays (HWIO kernels, BatchNorm
    scale/bias/mean/var, decoder modules named as in
    `depthmodelhardening_tpu/models/depth_decoder.py:374`); a tree of
    gradients, {"params": grads}, converts the same way.
    `from_jax_train_state` takes the JAX trainer's collections
    ({"params": {"depth": ...}, "batch_stats": {"depth": ...}});
    `from_jax_distill_state` a JAX `DistillState` with its Adam moments.
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


def from_jax_distill_state(state, scales: Sequence[int] = (0, 1, 2, 3)
                           ) -> Dict[str, object]:
    """A JAX `DistillState` (params, batch_stats, `optax.adam`'s opt_state
    and step; arrays or numpy) -> {"model": the port's state dict,
    "adam": {parameter name: torch.optim.Adam state}, "step": int}, for
    `DistillTrainer.make_state(resume=...)`. optax keeps one step count
    for all parameters, torch one per parameter: each gets the count."""
    adam = state.opt_state[0]  # optax.adam = chain(scale_by_adam, lr)
    count = torch.tensor(float(np.asarray(adam.count)))
    mu = from_jax_variables({"params": adam.mu}, scales)
    nu = from_jax_variables({"params": adam.nu}, scales)
    return {
        "model": from_jax_variables({"params": state.params,
                                     "batch_stats": state.batch_stats},
                                    scales),
        "adam": {name: {"step": count.clone(), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]} for name in mu},
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
