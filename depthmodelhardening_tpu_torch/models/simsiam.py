"""SimSiam contrastive head of the hardening step.

Counterpart of `depthmodelhardening_tpu/models/simsiam.py:1-69`
(reference DepthNetworks/monodepth2/contrastive.py:6-93): the deepest
encoder feature average-pooled in float32 (512 values on ResNet-18/34,
`in_dim` = 2048 on the Bottleneck ResNets: flax infers the first Dense's
input from the features), a 3-layer
projector to 1000 (its last BatchNorm affine-free), a 2-layer predictor
to 1000, and the symmetric negative cosine loss with the gradient
stopped on the projector's outputs.

Module names follow the flax ones (`projector_0` .. `predictor_3`), so
`models/convert.py` maps a JAX state onto this one by name. BatchNorm1d
with momentum 0.1 is flax's momentum 0.9; as everywhere in the port the
running variance takes torch's unbiased batch variance (flax: biased).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.profiling import counted
from .wrappers import flax_init_


def _cosine(a, b, eps: float = 1e-8):
    """a.b / max(|a||b|, eps) per row: torch nn.CosineSimilarity of the
    reference as JAX's `_cosine` writes it (F.cosine_similarity clamps
    each norm on its own, which is another function)."""
    na = torch.linalg.vector_norm(a, dim=1)
    nb = torch.linalg.vector_norm(b, dim=1)
    return torch.sum(a * b, dim=1) / torch.clamp(na * nb, min=eps)


def _bn(n: int, affine: bool = True) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(n, eps=1e-5, momentum=0.1, affine=affine)


class SimSiam(nn.Module):
    def __init__(self, dim: int = 1000, pred_dim: int = 512,
                 feat_dim: int = 512, in_dim: int = 512):
        super().__init__()
        self.projector_0 = nn.Linear(in_dim, feat_dim, bias=False)
        self.projector_1 = _bn(feat_dim)
        self.projector_3 = nn.Linear(feat_dim, feat_dim, bias=False)
        self.projector_4 = _bn(feat_dim)
        self.projector_6 = nn.Linear(feat_dim, dim, bias=False)
        self.projector_7 = _bn(dim, affine=False)
        self.predictor_0 = nn.Linear(dim, pred_dim, bias=False)
        self.predictor_1 = _bn(pred_dim)
        self.predictor_3 = nn.Linear(pred_dim, dim)

    def projector(self, z):
        z = torch.relu(self.projector_1(counted(self.projector_0, z)))
        z = torch.relu(self.projector_4(counted(self.projector_3, z)))
        return self.projector_7(counted(self.projector_6, z))

    def predictor(self, z):
        z = torch.relu(self.predictor_1(counted(self.predictor_0, z)))
        return counted(self.predictor_3, z)

    def forward(self, features_aug, features_ben):
        """The two encoder feature lists (NCHW; adversarial view, benign
        view) -> the scalar contrastive loss. BatchNorm statistics update
        in the module's train mode, in the reference's order: the
        projector on the adversarial view, then on the benign one, then
        the predictor likewise."""
        x1 = torch.mean(features_aug[-1].float(), dim=(2, 3))
        x2 = torch.mean(features_ben[-1].float(), dim=(2, 3))
        z1 = self.projector(x1)
        z2 = self.projector(x2)
        p1 = self.predictor(z1)
        p2 = self.predictor(z2)
        return -(torch.mean(_cosine(p1, z2.detach()))
                 + torch.mean(_cosine(p2, z1.detach()))) * 0.5


def init_simsiam(generator: torch.Generator, **kw) -> SimSiam:
    """A SimSiam head with flax's default initialisation drawn from
    `generator` (`models/wrappers.py:flax_init_`: lecun-normal Dense
    kernels, zero biases, identity BatchNorm)."""
    return flax_init_(SimSiam(**kw), generator)
