"""The yardstick's counts: the model family's FLOPs against hand counts
and published figures, each op's work against hand counts at small
shapes and against `chip_smoke.py`'s bounds at phase 3's shapes (the
figures PERF.md's kernel table gives, in ms)."""


import pytest
import torch

from counts import conv3x3, models, peaks, pool, reproj, warp


def _ms(work):
    nbytes, flops, peak = work
    return peaks.least_seconds(nbytes, flops, peak) * 1e3


def test_resnet_encoders_match_published_macs():
    # torchvision's ResNet-18 / -50 at 224x224 without the classifier:
    # 1.81 and 4.09 GMACs (2 FLOPs a multiply-add)
    assert models.conv_flops(models.encoder_convs(18, 224, 224)) \
        == pytest.approx(2 * 1.8135e9, rel=2e-3)
    assert models.conv_flops(models.encoder_convs(50, 224, 224)) \
        == pytest.approx(2 * 4.0872e9, rel=2e-3)


def test_encoder_hand_count_at_a_small_shape():
    # ResNet-18 at 32x32: conv1 to 16x16, the pool to 8x8, stage 1 at 8x8
    convs = {c[0]: c for c in models.encoder_convs(18, 32, 32)}
    assert convs["conv1"] == ("conv1", 3, 64, 7, 16, 16)
    assert convs["layer1.0.conv1"] == ("layer1.0.conv1", 64, 64, 3, 8, 8)
    assert convs["layer2.0.downsample"][1:] == (64, 128, 1, 4, 4)
    assert "layer1.0.downsample" not in convs
    assert models.conv_flops([convs["conv1"]]) == 2 * 3 * 64 * 49 * 16 * 16
    # ResNet-50's first bottleneck widens 64 -> 256 and so downsamples
    c50 = {c[0]: c for c in models.encoder_convs(50, 32, 32)}
    assert c50["layer1.0.conv3"][1:3] == (64, 256)
    assert c50["layer1.0.downsample"][1:] == (64, 256, 1, 8, 8)
    assert models.encoder_channels(50) == (64, 256, 512, 1024, 2048)


def test_decoder_hand_count():
    dec = {c[0]: c for c in models.decoder_convs(18, 64, 128)}
    assert dec["upconv_4_0"] == ("upconv_4_0", 512, 256, 3, 2, 4)
    assert dec["upconv_4_1"] == ("upconv_4_1", 256 + 256, 256, 3, 4, 8)
    assert dec["upconv_1_1"] == ("upconv_1_1", 32 + 64, 32, 3, 32, 64)
    assert dec["upconv_0_1"] == ("upconv_0_1", 16, 16, 3, 64, 128)
    assert dec["dispconv_0"] == ("dispconv_0", 16, 1, 3, 64, 128)
    assert len(dec) == 14  # 10 upconvs, 4 heads
    one_head = models.decoder_convs(18, 64, 128, heads=(0,))
    assert {c[0] for c in one_head} == set(dec) - {"dispconv_1",
                                                   "dispconv_2",
                                                   "dispconv_3"}


def test_least_seconds_of_recorded_passes():
    recs = [("conv", "bfloat16", 989e12, 1), ("conv", "float32", 165e12, 2)]
    assert models.least_seconds(recs) == pytest.approx(1.0 + 2.0)


def test_conv3x3_hand_count():
    x = ((2, 4, 10, 12), "float32")  # padded: output 8 x 10
    w = ((5, 4, 3, 3), "float32")
    b = ((5,), "float32")
    nbytes, flops, peak = conv3x3.work("fwd", (x, w, b, True))
    assert flops == (2 * 4 * 9 + 3) * (2 * 5 * 8 * 10)
    assert nbytes == 4 * (2 * 4 * 10 * 12 + 5 * 4 * 9 + 5 + 2 * 5 * 8 * 10)
    assert peak == peaks.PEAK_TF32_S / 3
    g = ((2, 5, 8, 10), "bfloat16")
    nbytes, flops, peak = conv3x3.work("dgrad_reflect",
                                       (g, ((5, 4, 3, 3), "bfloat16")))
    assert nbytes == 2 * (2 * 5 * 80 + 5 * 4 * 9 + 2 * 4 * 80)
    assert peak == peaks.PEAK_BF16_S


def test_pool_and_reproj_hand_counts():
    nbytes, flops, _ = pool.work("fwd", (((1, 2, 5, 7), "float32"),))
    assert (nbytes, flops) == (4 * (70 + 2 * 3 * 4), 8 * 2 * 3 * 4)
    x = ((1, 3, 4, 5), "float32")
    g = ((1, 4, 5), "float32")
    nbytes, flops, _ = reproj.work("fwd", (x, x))
    assert (nbytes, flops) == (4 * (2 * 60 + 20), 100 * 60)
    nbytes, flops, _ = reproj.work("bwd", (x, x, g, False))
    assert (nbytes, flops) == (4 * (3 * 60 + 20), 192 * 60)


def test_warp_counts_only_rows_in_reach():
    # one column, 4 tile rows; the map sends tile row y to object row
    # 0.5 y + 1: taps at rows 1..3 of a 3-row object, the last out of it
    A = torch.full((1, 1), 0.5)
    B = torch.full((1, 1), 1.0)
    t = ((1, 2, 3, 1), "float32")
    ab = ((1, 1), "float32")
    nbytes, flops, _ = warp.work("fwd", (t, ab, ab, 4, A, B))
    # y = 0..3 -> sy 1, 1.5, 2, 2.5: taps (1, 2), (1, 2), (2, 3), (2, 3);
    # rows 1, 2 touched; 4 tile rows with a tap in range
    assert flops == 4 * 2 * 4
    assert nbytes == 4 * 2 * 2 + 8 + 4 * 2 * 4
    nbytes, flops, _ = warp.work("bwd", (((1, 2, 4, 1), "float32"), ab, ab,
                                         3, A, B))
    assert flops == 2 * 2 * 6  # 6 taps in range
    assert nbytes == 4 * 2 * 4 + 8 + 4 * 2 * 3


# chip_smoke.py's bounds at phase 3's shapes (PERF.md's kernel table, ms)
def _conv_pass(shapes, op, dtype, padded):
    total = 0.0
    for _, cin, co, h, w in shapes:
        p = 2 if padded else 0
        x = ((32, cin, h + p, w + p), dtype)
        wt = ((co, cin, 3, 3), dtype)
        if op.startswith("fwd"):
            total += _ms(conv3x3.work(op, (x, wt, ((co,), dtype), True)))
        else:
            total += _ms(conv3x3.work(op, (((32, co, h, w), dtype), wt)))
    return total


FULL = (("upconv_1_0", 64, 32, 80, 256), ("upconv_0_0", 32, 16, 160, 512),
        ("upconv_0_1", 16, 16, 320, 1024), ("dispconv_0", 16, 1, 320, 1024))
CROP = (("upconv_1_0", 64, 32, 64, 80), ("upconv_0_0", 32, 16, 128, 160),
        ("upconv_0_1", 16, 16, 256, 320), ("dispconv_0", 16, 1, 256, 320))


@pytest.mark.parametrize("got, table", [
    (lambda: _conv_pass(FULL, "fwd", "float32", True), 0.9155),
    (lambda: _conv_pass(FULL, "dgrad", "float32", True), 0.9151),
    (lambda: _conv_pass(CROP, "fwd_reflect", "bfloat16", False), 0.1049),
    (lambda: _conv_pass(CROP, "dgrad_reflect", "bfloat16", False), 0.1049),
    (lambda: _ms(pool.work("fwd", (((12, 64, 160, 512), "float32"),))),
     0.0939),
    (lambda: _ms(pool.work("bwd", (((12, 64, 160, 512), "float32"),
                                   ((12, 64, 80, 256), "float32")))), 0.1690),
    (lambda: _ms(pool.work("fwd", (((32, 64, 128, 160), "bfloat16"),))),
     0.0313),
    (lambda: _ms(pool.work("bwd", (((32, 64, 128, 160), "bfloat16"),
                                   ((32, 64, 64, 80), "bfloat16")))), 0.0563),
    (lambda: _ms(reproj.work("fwd", (((32, 3, 320, 1024), "float32"),) * 2)),
     0.0876),
], ids=["D", "D-dgrad", "D-bf16", "D-bf16-dgrad", "B1", "B2", "B1-bf16",
        "B2-bf16", "C"])
def test_op_counts_match_chip_smoke_bounds(got, table):
    assert round(got(), 4) == table
