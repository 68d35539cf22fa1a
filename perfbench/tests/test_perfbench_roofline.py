"""The kernels' least times against counts worked out by hand at one
shape: 64x64, 2 subpalettes of 3 colours, prescreen 8 / 2, explore 4."""

import pytest

from perfbench import roofline
from perfbench.roofline import B_multiscale, C_coarse_redmean, G_dither_remap

CFG = dict(subpalette_count=2, subpalette_size=3, width=64, height=64,
           schedule="channel", prescreen=8, prescreen_full=2,
           channel_explore=4)
MEM, OPS = 3.35e12, 67e12
# Scales of a 64x64 image: 4096, 1024, 256, 64, 16, 4 pixels.


def test_scale_pixels():
    assert roofline.scale_pixels(64, 64) == [4096, 1024, 256, 64, 16, 4]
    assert roofline.scale_pixels(240, 256)[1:3] == [120 * 128, 60 * 64]


def test_metric_calls_by_hand():
    # 8 frames of 3x4096 float32 read, scale 1's 9 reference planes, 8 x 18
    # sums written; 680 operations at each of scale 1's 1024 pixels.
    b1 = 8 * 3 * 4096 * 4 + 9 * 1024 * 4 + 8 * 18 * 4
    o1 = 8 * 680 * 1024
    assert roofline.metric_call(CFG, 8, 1, 1, 1) == pytest.approx(
        max(b1 / MEM, o1 / OPS))
    # 2 frames at scale 0: no mean, 668 operations a pixel.
    b0 = 2 * 3 * 4096 * 4 + 9 * 4096 * 4 + 2 * 18 * 4
    o0 = 2 * 668 * 4096
    assert roofline.metric_call(CFG, 2, 0, 1, 0) == pytest.approx(
        max(b0 / MEM, o0 / OPS))
    # 36 frames taken down twice to scale 2: the mean at scale 1 (12 a
    # pixel), then scales 2-5.
    bc = 36 * 3 * 4096 * 4 + 9 * (256 + 64 + 16 + 4) * 4 + 36 * 4 * 18 * 4
    oc = 36 * (12 * 1024 + 680 * (256 + 64 + 16 + 4))
    assert roofline.metric_call(CFG, 36, 2, 4, 2) == pytest.approx(
        max(bc / MEM, oc / OPS))


def test_b_per_image():
    visit = (roofline.metric_call(CFG, 8, 1, 1, 1)
             + roofline.metric_call(CFG, 2, 0, 1, 0))
    image = roofline.metric_call(CFG, 1, 0, 6, 0)
    visits = 2 * 3 * 3
    assert B_multiscale.least_seconds(CFG, [8, 3]) == pytest.approx(
        2 * image + 11 * visits * visit)
    with pytest.raises(ValueError):
        B_multiscale.least_seconds(dict(CFG, gate_margin=0.01), [8])


def test_c_by_hand():
    b = 36
    n_bytes = (3 * 4096 * 4 + 4096 * 4 + 3 * 4096 * 4 + 3 * 256 * 4
               + b * 3 * 2 * 4 + 9 * (256 + 64 + 16 + 4) * 4 + b * 4 * 18 * 4)
    ops = b * (17 * 4096 + 668 * 256 + 680 * (64 + 16 + 4))
    assert C_coarse_redmean.least_seconds_visit(CFG) == pytest.approx(
        max(n_bytes / MEM, ops / OPS))
    assert C_coarse_redmean.least_seconds(CFG, [2, 1]) == pytest.approx(
        3 * 18 * max(n_bytes / MEM, ops / OPS))


def test_g_by_hand():
    cfg = dict(CFG, dither=True)
    b = 36
    n_bytes = 4096 * 4 + 64 * 4 + 6 * 3 * 4 + b * 3 * 4 + b * 4096 * 4
    ops = b * (40 * 4096 + 4096 * (15 + 3 * 14))
    assert G_dither_remap.call(cfg, b) == pytest.approx(
        max(n_bytes / MEM, ops / OPS))
    one = G_dither_remap.call(cfg, 1)
    assert G_dither_remap.least_seconds(cfg, [8]) == pytest.approx(
        2 * one + 8 * 18 * max(n_bytes / MEM, ops / OPS))


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def seconds_by_kernel(self):
        return self.seconds


@pytest.mark.parametrize("metric,kernel", [
    ("B_multiscale_roofline", B_multiscale),
    ("C_coarse_redmean_roofline", C_coarse_redmean),
    ("G_dither_remap_roofline", G_dither_remap)])
def test_readers_divide_least_by_device_time(metric, kernel):
    from perfbench import harness

    cfg = dict(CFG, dither=kernel is G_dither_remap)
    run = harness.Run(config=cfg, trace=_Trace({kernel.KERNEL: 0.5}),
                      traced_images=[{"steps": 8}, {"steps": 2}])
    got = harness.reader(metric)(run)
    assert got == pytest.approx(100 * kernel.least_seconds(cfg, [8, 2]) / 0.5)
    run.trace = _Trace({"glue": 1.0})
    assert harness.reader(metric)(run) is None


def test_cells_configs_carry_what_the_rooflines_read():
    from perfbench import harness

    for cell, kernels in [("mode1.balanced-256", (B_multiscale, C_coarse_redmean)),
                          ("mode1-dither.balanced-256", (B_multiscale, G_dither_remap)),
                          ("mode1.fast-256", (C_coarse_redmean,))]:
        spec = harness.cell_spec(cell)
        config = dict(spec.config, **spec.traffic["recipe"])
        for kernel in kernels:
            assert kernel.least_seconds(config, [8]) > 0
