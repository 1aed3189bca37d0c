"""Shared setup of tests/test_torch_classifier*.py.

JAX's tiny linear classifier (tests/test_classifier_attacks.py:11-31:
B 4, 8x8x3 images, logits = the NHWC image flattened times W) with its
weights carried to the port as numpy, the port's counterpart on NCHW
images, the layout helpers, and a small ResNet-18 classifier: a
ResnetEncoder(18), a global average pool of its last features and a
linear head (torchvision's ResNet-18 layout), in flax and in the port
with the same weights (`models/convert.py:from_jax_encoder`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from depthmodelhardening_tpu.models.resnet import (
    ResnetEncoder as JResnetEncoder,
)
from depthmodelhardening_tpu.models.torch_import import (
    convert_resnet_encoder,
)
from depthmodelhardening_tpu_torch.models.convert import from_jax_encoder
from depthmodelhardening_tpu_torch.models.resnet import ResnetEncoder

from golden_common import resnet18_encoder_state_dict

B, H, W = 4, 8, 8


def nchw(a) -> torch.Tensor:
    """An NHWC array as an NCHW float tensor (CPU)."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def j_linear(variables, x):
    return x.reshape(x.shape[0], -1) @ variables


class Linear(torch.nn.Module):
    """j_linear on NCHW images: the image read in NHWC order."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.from_numpy(np.array(w))

    def forward(self, x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ self.w


def linear_setup(n_classes: int, own_labels: bool):
    """(JAX weights, port model, x NHWC, labels) as the JAX tests build
    them: the labels drawn at random, or the model's own predictions."""
    wm = jax.random.normal(jax.random.PRNGKey(0), (H * W * 3, n_classes)) \
        * 0.5
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    if own_labels:
        x = jax.random.uniform(jax.random.PRNGKey(1), (B, H, W, 3))
        y = jnp.argmax(j_linear(wm, x), 1)
    else:
        x = jax.random.uniform(k1, (B, H, W, 3))
        y = jax.random.randint(k2, (B,), 0, n_classes)
    return wm, Linear(wm), x, y


def labels_t(y) -> torch.Tensor:
    return torch.from_numpy(np.array(y)).long()


def accuracy(model, x: torch.Tensor, y: torch.Tensor) -> float:
    with torch.no_grad():
        return float((model(x).argmax(1) == y).float().mean())


# -- the ResNet-18 classifier --------------------------------------------------
N_CLASSES = 10


class ResNetClassifier(torch.nn.Module):
    """The port's ResnetEncoder(18), a global average pool, a linear head:
    (B, 3, H, W) in [0, 1] -> (B, 10) logits."""

    def __init__(self):
        super().__init__()
        self.encoder = ResnetEncoder(18)
        self.head = torch.nn.Linear(512, N_CLASSES)

    def forward(self, x):
        return self.head(self.encoder(x)[-1].mean(dim=(2, 3)))


def resnet_classifier():
    """(flax logits_fn, its variables, the port's classifier in eval mode
    with the same weights): the encoder's weights are
    tests/golden_common.py's seeded torchvision ResNet-18 through the JAX
    package's converter, carried to the port by `from_jax_encoder`; the
    head's are seeded here."""
    enc = JResnetEncoder(18)
    enc_vars, _ = convert_resnet_encoder(resnet18_encoder_state_dict(0))
    rs = np.random.RandomState(0)
    head_w = (rs.standard_normal((512, N_CLASSES)) / np.sqrt(512.0)
              ).astype(np.float32)
    head_b = (rs.rand(N_CLASSES) * 0.2 - 0.1).astype(np.float32)

    def logits_fn(variables, x):
        f = enc.apply(variables["encoder"], x, train=False)[-1]
        return jnp.mean(f, axis=(1, 2)) @ variables["w"] + variables["b"]

    variables = {"encoder": enc_vars, "w": jnp.asarray(head_w),
                 "b": jnp.asarray(head_b)}
    port = ResNetClassifier()
    port.encoder.load_state_dict(from_jax_encoder(enc_vars))
    with torch.no_grad():
        port.head.weight.copy_(torch.from_numpy(head_w).T)
        port.head.bias.copy_(torch.from_numpy(head_b))
    return logits_fn, variables, port.eval()
