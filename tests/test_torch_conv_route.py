"""The bf16 convolutions' backend route (`ops/conv_route.py`) on the CPU.

* The rule: float32 (and float16, float64) never takes cuDNN; in bf16,
  every convolution of the ResNet-18 and ResNet-50 encoders and of the
  depth decoder routes as the measured table says (PERF.md §6): the
  image stem's forward on im2col, every other pass on cuDNN; kernel D's
  layers keep their forward and input gradient on D (its plain versions
  here), and only their weight gradient reaches the route.
* The route's Python logic (the flags around the forward, the pre-hook
  and hook around the backward node, the counters) runs on CPU tensors
  too, where the flags change nothing: forward values and input, weight
  and bias gradients equal plain `F.conv2d`'s bit for bit, and the
  process's cuDNN flags are as they were after each pass.
* The counters count each pass once, on the backend its route gives.
* The FLOP record (`profiling.flop_record()`) and the benchmark's
  `spans.counting()` of a small bf16 hardening step read the same
  (kind, dtype, flops, passes) entries with the route as with plain
  `F.conv2d` at every call site: 3 passes for the trained student's
  convolutions, 2 for the attack's.
"""

import os
import sys

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.models import matching_encoder, resnet
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import conv, conv_route
from depthmodelhardening_tpu_torch.ops.conv_route import CUDNN, IM2COL
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer
from depthmodelhardening_tpu_torch.utils import profiling
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16


def _flags():
    return (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32)


def _model_convs(layers: int):
    """(name, kernel, stride, cin, co, takes D) of every convolution of
    the Monodepth2 model on a ResNet-`layers` encoder."""
    model = make_monodepth2(layers)
    out = []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            dec = name.startswith("decoder.")
            cin, co = m.in_channels, m.out_channels
            out.append((name, m.kernel_size, m.stride[0], cin, co,
                        dec and conv.takes_kernel(cin, co)))
    return out


# -- the rule -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("pass_", conv_route.PASSES)
def test_no_dtype_but_bf16_takes_cudnn(dtype, pass_):
    for kernel, stride, cin, co in (((7, 7), 2, 3, 64), ((3, 3), 1, 64, 64),
                                    ((1, 1), 2, 1024, 2048),
                                    ((3, 3), 1, 96, 32), ((3, 3), 1, 16, 1)):
        assert conv_route.route(dtype, pass_, kernel, stride, cin,
                                co) == IM2COL


@pytest.mark.parametrize("layers", [18, 50])
def test_bf16_model_convs_route_as_the_table_says(layers):
    convs = _model_convs(layers)
    assert sum(d for *_, d in convs) == 6  # D's layers: 16, 32, 64 wide
    for name, kernel, stride, cin, co, on_d in convs:
        want = {"fwd": IM2COL if name == "encoder.conv1" else CUDNN,
                "dgrad": CUDNN, "wgrad": CUDNN}
        for p in conv_route.PASSES:
            if on_d and p != "wgrad":
                continue  # kernel D's: never routed (next test)
            assert conv_route.route(BF16, p, kernel, stride, cin,
                                    co) == want[p], (name, p)


def test_route_refuses_an_unknown_pass():
    with pytest.raises(ValueError, match="pass"):
        conv_route.route(BF16, "bwd", (3, 3), 1, 64, 64)


def _counting_d(monkeypatch):
    """Kernel D's bf16 calls on the CPU (its plain versions, which
    recurse once in float32)."""
    calls = {"fwd": 0, "dgrad": 0}
    fwd, dgrad = conv.conv3x3_reflect_plain, conv.conv3x3_dgrad_reflect_plain

    def fwd_rec(x, *a, **k):
        calls["fwd"] += x.dtype == BF16
        return fwd(x, *a, **k)

    def dgrad_rec(g, *a, **k):
        calls["dgrad"] += g.dtype == BF16
        return dgrad(g, *a, **k)
    monkeypatch.setattr(conv, "conv3x3_reflect_plain", fwd_rec)
    monkeypatch.setattr(conv, "conv3x3_dgrad_reflect_plain", dgrad_rec)
    return calls


@pytest.mark.parametrize("cin,co", [(16, 16), (64, 32), (32, 1)])
def test_kernel_d_keeps_its_forward_and_input_gradient(cin, co,
                                                       monkeypatch):
    calls = _counting_d(monkeypatch)
    g = torch.Generator().manual_seed(cin + co)
    x = torch.rand(2, cin, 9, 13, generator=g).to(BF16).requires_grad_(True)
    w = (torch.randn(co, cin, 3, 3, generator=g) / 12).to(BF16)
    w.requires_grad_(True)
    b = torch.zeros(co, dtype=BF16, requires_grad=True)
    conv_route.reset_passes()
    conv.conv3x3_reflect(x, w, b, True).sum().backward()
    assert calls == {"fwd": 1, "dgrad": 1}
    assert {k: v for k, v in conv_route.passes().items() if v} == {
        "cudnn.wgrad": 1}


def test_wide_decoder_conv_takes_the_route_not_d(monkeypatch):
    calls = _counting_d(monkeypatch)
    x = torch.rand(2, 96, 9, 13).to(BF16).requires_grad_(True)
    w = (torch.randn(32, 96, 3, 3) / 30).to(BF16).requires_grad_(True)
    b = torch.zeros(32, dtype=BF16, requires_grad=True)
    conv_route.reset_passes()
    conv.conv3x3_reflect(x, w, b, True).sum().backward()
    assert calls == {"fwd": 0, "dgrad": 0}
    assert {k: v for k, v in conv_route.passes().items() if v} == {
        "cudnn.fwd": 1, "cudnn.dgrad": 1, "cudnn.wgrad": 1}


# -- the same bits as F.conv2d ------------------------------------------------
SHAPES = [  # x (B, Cin, H, W), w's (Co, kh, kw), stride, padding, bias
    ((2, 3, 32, 48), (8, 7, 7), 2, 3, False),  # a stem: im2col forward
    ((2, 16, 12, 20), (24, 3, 3), 1, 1, False),
    ((2, 16, 12, 20), (32, 3, 3), 2, 1, False),
    ((2, 32, 12, 20), (16, 1, 1), 2, 0, False),
    ((2, 24, 14, 22), (8, 3, 3), 1, 0, True),  # a wide decoder conv
]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_routed_conv_equals_plain_bit_for_bit(shape, dtype):
    xs, (co, kh, kw), stride, pad, bias = shape
    g = torch.Generator().manual_seed(sum(xs) + co)
    x = torch.rand(xs, generator=g).to(dtype)
    w = (torch.randn(co, xs[1], kh, kw, generator=g)
         / (xs[1] * kh * kw) ** 0.5).to(dtype)
    b = (0.1 * torch.randn(co, generator=g)).to(dtype) if bias else None
    out = []
    before = _flags()
    for fn in (conv_route.conv2d, F.conv2d):
        leaves = [t.clone().requires_grad_(True) for t in (x, w)]
        if bias:
            leaves.append(b.clone().requires_grad_(True))
        y = fn(*leaves[:2], leaves[2] if bias else None, stride, pad)
        ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)
                         ).to(dtype)
        y.backward(ct)
        out.append([y.detach()] + [t.grad for t in leaves])
        assert _flags() == before
    for got, want in zip(*out):
        assert got.dtype == dtype and torch.equal(got, want)


# -- the counters -------------------------------------------------------------
@pytest.mark.parametrize("x_grad,w_grad,want", [
    (True, True, {"cudnn.fwd": 1, "cudnn.dgrad": 1, "cudnn.wgrad": 1}),
    (True, False, {"cudnn.fwd": 1, "cudnn.dgrad": 1}),  # the attack
    (False, True, {"cudnn.fwd": 1, "cudnn.wgrad": 1}),  # a stem in training
    (False, False, {"cudnn.fwd": 1}),
])
def test_counters_count_each_pass_once(x_grad, w_grad, want):
    x = torch.rand(2, 16, 10, 12).to(BF16).requires_grad_(x_grad)
    w = (torch.randn(8, 16, 3, 3) / 12).to(BF16).requires_grad_(w_grad)
    conv_route.reset_passes()
    y = conv_route.conv2d(x, w, None, 1, 1)
    if x_grad or w_grad:
        y.float().sum().backward()
    assert {k: v for k, v in conv_route.passes().items() if v} == want


def test_counters_stem_no_grad_float32_and_d_weight_grad():
    conv_route.reset_passes()
    x = torch.rand(2, 3, 16, 24).to(BF16).requires_grad_(True)
    w = torch.randn(8, 3, 7, 7).to(BF16).requires_grad_(True)
    conv_route.conv2d(x, w, None, 2, 3).float().sum().backward()
    with torch.no_grad():
        conv_route.conv2d(x, w, None, 2, 3)
    x32 = torch.rand(2, 16, 8, 8, requires_grad=True)
    conv_route.conv2d(x32, torch.randn(4, 16, 3, 3), None, 1, 1).sum(
        ).backward()
    xp, g = torch.rand(2, 16, 10, 12).to(BF16), torch.rand(2, 4, 8, 10)
    dw = conv.weight_grad(xp, torch.zeros(4, 16, 3, 3, dtype=BF16),
                          g.to(BF16))
    assert torch.equal(dw, torch.nn.grad.conv2d_weight(
        xp, (4, 16, 3, 3), g.to(BF16)))
    assert {k: v for k, v in conv_route.passes().items() if v} == {
        "im2col.fwd": 2, "cudnn.dgrad": 1, "cudnn.wgrad": 2}
    conv_route.reset_passes()
    assert set(conv_route.passes().values()) == {0}


# -- what the FLOP counts read ------------------------------------------------
def _plain_route(monkeypatch):
    """Every call site back on plain F.conv2d and conv2d_weight."""
    plain = (lambda x, w, bias=None, stride=1, padding=0:
             F.conv2d(x, w, bias, stride, padding))
    for mod in (resnet, matching_encoder, conv_route):
        monkeypatch.setattr(mod, "conv2d", plain)
    monkeypatch.setattr(conv_route, "weight_grad",
                        lambda xp, w, g: torch.nn.grad.conv2d_weight(
                            xp, w.shape, g))


@pytest.fixture(scope="module")
def bf16_step():
    """A small bf16 L0 hardening step (the CLI's default trainer at 64x192,
    batch 2, attack batch 2, 2 steps) from a fresh state and fixed draws
    each call."""
    cfg = HardeningConfig(
        selfsup=SelfSupConfig(height=64, width=192),
        adv=AdvSynthConfig(ori_h=96, ori_w=320, norm_type="l_0", steps=2,
                           attack_batch_size=2),
        batch_size=2, compute_dtype="bfloat16")
    obj, mask = make_car_object(36, 24)
    tr = HardeningTrainer(cfg, torch.Generator().manual_seed(0), obj, mask,
                          predictor_from(make_monodepth2()), device="cpu")
    frames = {f: torch.from_numpy(make_scene(2, 96, 320, seed=i))
              for i, f in enumerate("0s")}
    scene = torch.from_numpy(make_scene(1, 96, 320, seed=5))
    sides, flips = torch.tensor([True, False]), torch.tensor([False, True])
    draws = tr.draw(2)
    draws.identity_noise = torch.randn(
        tr.identity_noise_shape(2), generator=torch.Generator().manual_seed(2))

    def step():
        _, m = tr.train_step(tr.make_state(), frames, sides, flips, scene,
                             draws=draws)
        return tr.attack.last_iterations, float(m["loss"])
    return step


def _records(step):
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    try:
        from harness import spans
    finally:
        sys.path.remove(os.path.join(REPO, "benchmark"))
    profiling.reset_flops()
    with profile(activities=[ProfilerActivity.CPU]):
        first = step()
    flops = sorted(profiling.flop_record())
    profiling.reset_flops()
    with spans.counting() as rec:
        second = step()
    assert first == second
    return first, flops, sorted(rec.model)


def test_flop_counts_read_the_same_with_the_route(bf16_step, monkeypatch):
    conv_route.reset_passes()
    routed = _records(bf16_step)
    passes = conv_route.passes()
    _plain_route(monkeypatch)
    plain = _records(bf16_step)
    assert routed == plain
    _, flops, counted = routed
    bf16 = {p for k, d, _, p in flops if d == "bfloat16"}
    assert bf16 == {2, 3}  # the attack's passes, the student's
    assert {p for k, d, _, p in counted if d == "bfloat16"} == bf16
    assert passes["cudnn.fwd"] > 0 and passes["cudnn.dgrad"] > 0
    assert passes["cudnn.wgrad"] > 0 and passes["im2col.dgrad"] == 0
