"""SSIMULACRA2 metric of the port against the JAX package on the CPU.

Tolerance 2e-4 (absolute and relative) on features and pyramid planes:
the two packages sum in different orders in float32, and the SSIM variance
terms amplify that; tests/test_batched_kernels.py holds the Pallas and XLA
paths to the same bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.core.state import pyramid_from_numpy, pyramid_to_numpy
from snesimage_torch.ops import ssimulacra2 as tss
from snesimage_tpu.ops import ssimulacra2 as jss

TOL = 2e-4


def _img(rng, h=64, w=64):
    base = rng.random((h, w, 3)).astype(np.float32)
    k = np.ones((4, 4)) / 16.0
    for c in range(3):
        base[..., c] = np.real(
            np.fft.ifft2(np.fft.fft2(base[..., c]) * np.fft.fft2(k, (h, w)))
        )
    return np.clip(base, 0, 1).astype(np.float32)


@pytest.fixture
def pair(rng):
    """(u8 reference, JAX pyramid, port pyramid, linear candidate frames)."""
    ref = (_img(rng) * 255).round().astype(np.int32)
    jp = jss.reference_pyramid(jnp.asarray(ref))
    tp = tss.reference_pyramid(torch.from_numpy(ref))
    lin = rng.random((3, 64, 64, 3)).astype(np.float32) ** 2.2
    return ref, jp, tp, lin


def test_blur_taps_are_the_jax_matrix_entries():
    mat = jss._blur_matrix(40)
    taps = tss.blur_taps()
    np.testing.assert_array_equal(mat[20, 12:29], taps)
    np.testing.assert_array_equal(tss._blur_matrix(40, torch.device("cpu")), mat)


def test_reference_pyramid(pair):
    _, jp, tp, _ = pair
    for js, ts in zip(jp, tp):
        for a, b in zip(js, ts):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize(
    "skip,inp,mx", [(0, 0, 6), (2, 0, 6), (2, 2, 6), (0, 0, 2), (1, 1, 2)]
)
def test_scale_features(pair, skip, inp, mx):
    _, jp, tp, lin = pair
    for _ in range(inp):
        lin = np.asarray(jss.downsample2(jnp.asarray(lin)))
    want = jss.scale_features(jp, jnp.asarray(lin), skip_scales=skip,
                              input_scale=inp, max_scale=mx)
    got = tss.scale_features(tp, torch.from_numpy(lin), skip_scales=skip,
                             input_scale=inp, max_scale=mx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    # (start_scale, num_scales, pre_ds): the frame error, the scale-1
    # rank, the scale-0 finalists and the coarse stage of the main path
    "start,n,pre_ds", [(0, 6, 0), (1, 1, 1), (0, 1, 0), (2, 4, 0)]
)
def test_fused_scale_feature_block(pair, start, n, pre_ds):
    _, jp, tp, lin = pair
    for _ in range(start - pre_ds):
        lin = np.asarray(jss.downsample2(jnp.asarray(lin)))
    frames = np.ascontiguousarray(np.moveaxis(lin, -1, 1))
    want = jss.fused_scale_feature_block(jp, jnp.asarray(frames), start, n,
                                         pre_ds=pre_ds)
    got = tss.fused_scale_feature_block(tp, torch.from_numpy(frames), start,
                                        n, pre_ds=pre_ds)
    assert got.shape == (3, 6, 3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    e_t = tss.score_from_features(got).numpy()
    e_j = np.asarray(jss.score_from_features(want))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4, atol=1e-3)


def test_fused_scale_feature_block_rejects_uneven_pyramids(rng):
    """60x60 halves to 15x15, then to 8x8 by edge replication. The block
    follows that pyramid as the JAX package does (2e-4), and rejects only a
    pyramid whose sizes are not those of the frames' own downsamples."""
    ref = (_img(rng, 60, 60) * 255).round().astype(np.int32)
    jp = jss.reference_pyramid(jnp.asarray(ref))
    tp = tss.reference_pyramid(torch.from_numpy(ref))
    assert [tuple(s[0].shape[:2]) for s in tp] == [
        (60, 60), (30, 30), (15, 15), (8, 8), (4, 4), (2, 2)]
    frames = rng.random((2, 3, 60, 60)).astype(np.float32)
    want = jss.fused_scale_feature_block(jp, jnp.asarray(frames), 0, 6)
    got = tss.fused_scale_feature_block(tp, torch.from_numpy(frames), 0, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        tss.fused_scale_feature_block(tp, torch.from_numpy(frames[..., :56]),
                                      0, 6)
    with pytest.raises(ValueError):  # frames of scale 0 offered as scale 1
        tss.fused_scale_feature_block(tp, torch.from_numpy(frames), 1, 2)


def test_pyramid_carried_from_numpy(pair):
    _, jp, _, lin = pair
    tp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in scale) for scale in jp), "cpu"
    )
    back = pyramid_to_numpy(tp)
    for js, bs in zip(jp, back):
        for a, b in zip(js, bs):
            np.testing.assert_array_equal(b, np.asarray(a))
    got = tss.scale_features(tp, torch.from_numpy(lin))
    want = jss.scale_features(jp, jnp.asarray(lin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_golden_score_values():
    """The pinned scores of tests/test_ssimulacra2.py, from the port."""
    rng = np.random.default_rng(1234)
    img = _img(rng, 128, 128)
    expected = {0.02: 59.7591, 0.1: -59.0412}
    for sigma, want in expected.items():
        noisy = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1).astype(
            np.float32
        )
        got = float(tss.ssimulacra2(torch.from_numpy(img),
                                    torch.from_numpy(noisy)))
        assert abs(got - want) < 0.05, (sigma, got, want)
    half = img[::2, ::2].repeat(2, 0).repeat(2, 1)
    got = float(tss.ssimulacra2(torch.from_numpy(img), torch.from_numpy(half)))
    assert abs(got - (-40.0645)) < 0.05, got


@pytest.mark.parametrize("skip,inp", [(0, 0), (2, 0), (2, 2)])
def test_ssimulacra2_from_ref_linear(pair, skip, inp):
    """Scores of three linear frames through `fused_scale_feature_block`
    against the JAX package's `ssimulacra2_from_ref_linear`, vmapped over
    the frames; skipped scales count as zero features in both (1e-3 on
    the scores, as for `test_fused_scale_feature_block`)."""
    import jax

    _, jp, tp, lin = pair
    for _ in range(inp):
        lin = np.asarray(jss.downsample2(jnp.asarray(lin)))
    want = jax.vmap(lambda f: jss.ssimulacra2_from_ref_linear(
        jp, f, skip_scales=skip, input_scale=inp))(jnp.asarray(lin))
    got = tss.ssimulacra2_from_ref_linear(tp, torch.from_numpy(lin),
                                          skip_scales=skip, input_scale=inp)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    one = tss.ssimulacra2_from_ref_linear(tp, torch.from_numpy(lin[0]),
                                          skip_scales=skip, input_scale=inp)
    assert one.shape == () and float(one) == float(got[0])


def test_ssimulacra2_from_ref_and_error_of(pair, small_image):
    """`ssimulacra2_from_ref` on an 8-bit frame, and `refine.error_of` of a
    clustered state (one image and a batch of two), against the JAX
    package's (scores as in `test_fused_scale_feature_block`); `error_of`
    equals `frame_error_fused` (both kernel B)."""
    from snesimage_torch.config import QuantConfig as TConfig
    from snesimage_torch.core import refine as tref
    from snesimage_torch.core.state import state_from_numpy, stack_states
    from snesimage_tpu.config import QuantConfig as JConfig
    from snesimage_tpu.core import pipeline as jpipe
    from snesimage_tpu.core import refine as jref
    from snesimage_tpu.core.state import new_state as j_new_state

    ref, jp, tp, _ = pair
    dis = np.clip(ref + np.random.default_rng(2).integers(
        -20, 21, ref.shape), 0, 255).astype(np.int32)
    want = float(jss.ssimulacra2_from_ref(jp, jnp.asarray(dis)))
    got = tss.ssimulacra2_from_ref(tp, torch.from_numpy(dis))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-4, atol=1e-3)

    kw = dict(subpalette_count=2, subpalette_size=4, width=64, height=64)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = jpipe.cluster(jpipe.initialize(j_new_state(small_image, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    err = tref.error_of(ts, tc, trefp)
    assert err.shape == ()
    assert abs(float(err) - float(jref.error_of(js, jc, jrefp))) <= 1e-3
    assert torch.equal(err, tref.frame_error_fused(ts, tc, trefp))
    both = stack_states([ts, ts])
    errs = tref.error_of(both, tc, tss.stack_pyramids([trefp, trefp]))
    assert errs.shape == (2,) and (errs == err).all()
