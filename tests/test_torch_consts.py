"""The port's copies of the framework-free modules stay pinned to the JAX
package's originals, and the port never imports JAX or the JAX package."""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import snesimage_torch.config as tcfg
import snesimage_torch.constants as tconst
import snesimage_torch.ops.ssimulacra2_consts as tss
import snesimage_tpu.config as jcfg
import snesimage_tpu.constants as jconst
import snesimage_tpu.ops.ssimulacra2_consts as jss

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "name", ["config.py", "constants.py", "ops/ssimulacra2_consts.py"]
)
def test_copies_are_verbatim(name):
    """Only the module docstring and the package name in import lines may
    differ; every line of code and comment after the docstring is equal."""
    original = _after_docstring((ROOT / "snesimage_tpu" / name).read_text())
    copy = _after_docstring((ROOT / "snesimage_torch" / name).read_text())
    assert copy == original.replace(
        "from snesimage_tpu.", "from snesimage_torch."
    )


def _after_docstring(text: str) -> str:
    body = ast.parse(text).body
    assert body and isinstance(body[0], ast.Expr)
    assert isinstance(body[0].value, ast.Constant)
    return "".join(text.splitlines(keepends=True)[body[0].end_lineno:])


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        dict(subpalette_count=8, subpalette_size=15, schedule="channel",
             prescreen=8, prescreen_full=2, channel_explore=16,
             accept_margin=0.005),
        dict(perceptual_palettes=True, prescreen=8, prescreen_full=2),
        dict(gate_margin=0.01, channel_explore=4, schedule="channel"),
        dict(gate_margin=0.01, channel_window=2, schedule="channel"),
    ],
)
def test_quant_config_matches(kwargs):
    a = tcfg.QuantConfig(**kwargs)
    b = jcfg.QuantConfig(**kwargs)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.width_tiles, a.height_tiles, a.num_tiles) == (
        b.width_tiles, b.height_tiles, b.num_tiles
    )


@pytest.mark.parametrize(
    "kwargs",
    [dict(width=60), dict(subpalette_size=16), dict(schedule="x"),
     dict(prescreen=4, prescreen_pre=3), dict(gate_coarse=True)],
)
def test_quant_config_rejects_alike(kwargs):
    for cls in (tcfg.QuantConfig, jcfg.QuantConfig):
        with pytest.raises(ValueError):
            cls(**kwargs)


@pytest.mark.parametrize("pair", [(tconst, jconst), (tss, jss)])
def test_constant_values_equal(pair):
    mine, theirs = pair
    names = [n for n in vars(theirs) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(
            np.asarray(getattr(mine, n)), np.asarray(getattr(theirs, n)), n
        )


def test_nes_table_pinned():
    """The 56 NES colours as 5-bit triples (54 distinct: two pairs of
    entries coincide at 5 bits), equal to the JAX package's and to the hash
    of the table as it was copied."""
    import hashlib

    table = tconst.NES_PALETTE_5BIT
    assert table.shape == (56, 3) and table.dtype == np.int32
    assert table.min() >= 0 and table.max() <= 31
    assert len({tuple(row) for row in table.tolist()}) == 54
    np.testing.assert_array_equal(table, jconst.NES_PALETTE_5BIT)
    assert hashlib.sha256(table.tobytes()).hexdigest() == (
        "b91d485aade138e84084a9b70742dd9adfd3a58a7853394ea6d617077b220e18")


def test_import_leaves_jax_out():
    """Importing every port module (and chip_smoke) in a fresh process
    loads neither jax nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import snesimage_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(snesimage_torch.__path__,"
        " 'snesimage_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'snesimage_tpu')]\n"
        "print(len(list(pkgutil.walk_packages(snesimage_torch.__path__))))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|snesimage_tpu)\b",
                         re.MULTILINE)
    pkg = ROOT / "snesimage_torch"
    files = sorted(  # build/ holds generated output, not sources
        p for p in pkg.rglob("*.py") if "build" not in p.relative_to(pkg).parts
    ) + [ROOT / "chip_smoke.py", ROOT / "profile_torch.py"]
    assert len(files) > 10
    for entry in ("cli.py", "batch_cli.py", "parallel/batch.py",
                  "io/checkpoint.py", "io/image.py", "preview.py",
                  "core/reassign.py", "utils/profiling.py", "bench.py",
                  "benchmarks.py"):
        assert pkg / entry in files, entry
    for path in files:
        assert not pattern.search(path.read_text()), path
    # The port's scripts do not lean on the JAX package's bench harness.
    harness = re.compile(r"^\s*(import|from)\s+bench(marks)?\b", re.MULTILINE)
    for path in files:
        assert not harness.search(path.read_text()), path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bench_image_copy_equals_the_original(seed):
    """snesimage_torch.testing.bench_image is bench._test_image."""
    from bench import _test_image
    from snesimage_torch.testing import bench_image, with_transparency

    img = bench_image(seed)
    np.testing.assert_array_equal(img, _test_image(seed))
    assert img.dtype == np.uint8 and img.shape == (256, 256, 4)
    clear = with_transparency(img)
    share = (clear[..., 3] == 0).mean()
    assert 0.05 < share < 0.3 and (img[..., 3] == 255).all()
    np.testing.assert_array_equal(clear[clear[..., 3] > 0],
                                  img[clear[..., 3] > 0])
