"""The dither proxy (`dither_proxy`) against the JAX package on the CPU, at
32x32 (as tests/test_torch_refine.py's dithered visits): a dithered visit
ranks its candidates by their exact undithered coarse score and scores
only the top K through the wavefront. Exactly K rows are finite (K + 1
with the current colour scored inside the batch, row 0), the same rows as
in the JAX package, and their errors agree within 1e-2 (the bound
tests/test_refine.py holds the proxied rows to the unproxied ones;
measured 4.5e-4 here, 3e-6 relative)."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snesimage_torch.config import QuantConfig as TConfig
from snesimage_torch.core import refine as tref
from snesimage_torch.core.state import pyramid_from_numpy, state_from_numpy
from snesimage_torch.testing import single_torch_thread
from snesimage_tpu.config import QuantConfig as JConfig
from snesimage_tpu.core import pipeline as jpipe
from snesimage_tpu.core import refine as jref
from snesimage_tpu.core.state import new_state as j_new_state

K = 6
ERR_TOL = 1e-2
CFG = dict(subpalette_count=2, subpalette_size=4, width=32, height=32,
           schedule="channel", prescreen=8, prescreen_full=2, dither=True,
           dither_proxy=K)


# Jitted, as the JAX package's sweeps run it (eager, it takes 20 s here).
_jax_errors = jax.jit(jref._candidate_errors_dithered, static_argnums=(1,),
                      static_argnames=("carried_base",))


@lru_cache(maxsize=None)
def _setup(image_bytes: bytes):
    img = np.frombuffer(image_bytes, np.uint8).reshape(64, 64, 4)
    img = np.ascontiguousarray(img[:32, :32])
    jc, tc = JConfig(**CFG), TConfig(**CFG)
    js = jpipe.cluster(jpipe.initialize(j_new_state(img, jc), jc), jc)
    jrefp = jref.make_reference_pyramid(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          "cpu")
    trefp = pyramid_from_numpy(
        tuple(tuple(np.asarray(a) for a in s) for s in jrefp), "cpu")
    return (js, jc, jrefp), (ts, tc, trefp)


@pytest.mark.parametrize("carried", [True, False])
def test_proxy_rows_match_jax(small_image, carried):
    """24 random candidates of slot (1, 2), with the current colour as row
    0 where it is scored inside the batch: the JAX package's finite rows,
    their errors within 1e-2, and the maps of the finite rows are kernel
    G's for those candidates (the rest zero maps, which nothing reads)."""
    (js, jc, jrefp), (ts, tc, trefp) = _setup(small_image.tobytes())
    cands = np.random.default_rng(0).integers(0, 32, (24, 3)).astype(np.int32)
    if not carried:
        cands = np.concatenate([np.asarray(js.palette)[1, 2][None], cands])
    want = np.asarray(_jax_errors(js, jc, jrefp, 1, 2, jnp.asarray(cands),
                                  carried_base=carried))
    with single_torch_thread():
        got, maps = tref._candidate_errors_dithered(
            ts, tc, trefp, 1, 2, torch.from_numpy(cands),
            carried_base=carried)
        finite = torch.isfinite(got)
        unproxied = tref._candidate_errors_dithered(
            ts, TConfig(**dict(CFG, dither_proxy=0)), trefp, 1, 2,
            torch.from_numpy(cands)[finite], carried_base=True)[1]
    got = got.numpy()
    assert finite.sum() == K + (0 if carried else 1)
    assert carried or np.isfinite(got[0])
    np.testing.assert_array_equal(finite.numpy(), np.isfinite(want))
    np.testing.assert_allclose(got[finite.numpy()], want[np.isfinite(want)],
                               rtol=0, atol=ERR_TOL)
    assert torch.equal(maps[finite], unproxied)
    assert not maps[~finite].any()
