"""Train-mode BatchNorm over the global batch of a data-parallel mesh.

Under the JAX package's mesh a train-mode BatchNorm normalises with the
mean and variance of the global batch. `GlobalBatchNorm` gives each rank
the single-process `nn.BatchNorm2d` / `BatchNorm1d` result over the
global batch from its own rows (torch's `SyncBatchNorm` refuses CPU
tensors, and gathers):

* forward: one all-reduce of the count and of sum(x) a channel (the
  global mean), then one of sum((x - mean)^2) (the biased variance):
  two passes, as torch computes it, not sum(x^2) - n mean^2, which loses
  the digits flax's one-pass variance loses. Statistics in float32 for
  bf16 activations, as `nn.BatchNorm2d` computes them (in float64 for
  float64 ones); the output in the input's dtype;
* backward: one all-reduce of sum(dy) and sum(dy * x_hat) a channel.
  Each rank's loss is a mean over its rows, so its dy is world_size times
  the global loss's; the global means of dy then give world_size times
  the global input gradient on each rank's rows, and the weight and bias
  gradients are the rank's own sums: averaging every gradient over the
  ranks (the trainers' `Mesh.all_mean`) gives the global gradient;
* running statistics as torch updates them: momentum, and the unbiased
  variance n / (n - 1) of the global count n.

Eval mode is `nn.BatchNorm2d`'s (running statistics, no collective), and
the tensors are the module's own, so the BatchNorm fold
(`models/resnet.py:_folded_conv`) and `EvalView` read them as before.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import Mesh


class _GlobalBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = torch.full((1,), x.numel() // x.shape[1], dtype=xf.dtype,
                           device=x.device)
        sums = torch.cat([xf.sum(dims), count])
        dist.all_reduce(sums, group=group)
        n = sums[-1]
        mean = sums[:-1] / n
        xc = xf - mean.view(shape)
        sq = (xc * xc).sum(dims)
        dist.all_reduce(sq, group=group)
        invstd = torch.rsqrt(sq / n + eps)
        xhat = xc * invstd.view(shape)
        y = xhat if weight is None else xhat * weight.view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.group = group
        ctx.in_dtype = x.dtype
        ctx.mark_non_differentiable(mean, sq, n)
        return y.to(x.dtype), mean, sq, n

    @staticmethod
    def backward(ctx, dy, *_):
        xhat, invstd, weight, n = ctx.saved_tensors
        dims = [0] + list(range(2, xhat.dim()))
        shape = [1, -1] + [1] * (xhat.dim() - 2)
        dyf = dy.to(xhat.dtype)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        C = sum_dy.shape[0]
        mean_dy, mean_dy_xhat = sums[:C] / n, sums[C:] / n
        scale = invstd if weight is None else invstd * weight
        dx = (dyf - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)) \
            * scale.view(shape)
        dw = db = None
        if weight is not None:
            dw, db = sum_dy_xhat, sum_dy
        return dx.to(ctx.in_dtype), dw, db, None, None


class GlobalBatchNorm(nn.modules.batchnorm._BatchNorm):
    """`nn.BatchNorm1d` / `BatchNorm2d` whose train-mode statistics are
    the mesh's global batch's. Build one with `global_batchnorm`."""

    mesh: Mesh

    def _check_input_dim(self, x):
        if x.dim() not in (2, 3, 4):
            raise ValueError(f"expected 2D, 3D or 4D input (got {x.dim()}D)")

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, sq, n = _GlobalBatchNorm.apply(
            x, self.weight, self.bias, self.eps, self.mesh.group)
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * (sq / (n - 1)))
        return y


def global_batchnorm(module: nn.Module, mesh: Mesh) -> nn.Module:
    """`module` with every BatchNorm replaced by a `GlobalBatchNorm` on
    the same parameters and buffers (as `nn.SyncBatchNorm.
    convert_sync_batchnorm` does); returns the converted module."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm) and \
            not isinstance(module, GlobalBatchNorm):
        out = GlobalBatchNorm(module.num_features, module.eps,
                              module.momentum, module.affine,
                              module.track_running_stats,
                              device=module.running_mean.device)
        out.mesh = mesh
        if module.affine:
            out.weight, out.bias = module.weight, module.bias
        out.running_mean, out.running_var = (module.running_mean,
                                             module.running_var)
        out.num_batches_tracked = module.num_batches_tracked
        out.train(module.training)
        return out
    for name, child in module.named_children():
        module._modules[name] = global_batchnorm(child, mesh)
    return module
