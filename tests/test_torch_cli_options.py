"""Four options of the optimizer through the port's CLI against the JAX
CLI on the CPU (`main(..., device="cpu")`): `--prescreen-pre` (the
three-level prescreen), `--dither-proxy`, `--channel-window` and
`--gate-coarse`, each on tests/test_torch_cli.py's CHANNEL recipe at
256x256 with 2x3 palettes. No random draw enters, so the JSON must be the
JAX CLI's byte for byte, and the step errors agree within 1e-3.

The JAX CLI's side of each case takes about half a minute on the CPU, so
it is frozen in tests/data/cli_options_jax.json: the sha256 of its JSON
bytes and its step errors, written by

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cli_options.py --freeze

from the JAX package, which does not change."""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import snesimage_torch.cli as tcli
from snesimage_torch.testing import bench_image, single_torch_thread

FROZEN = Path(__file__).with_name("data") / "cli_options_jax.json"
# tests/test_torch_cli.py's deterministic recipe: channel sweeps, no
# explore draws.
CHANNEL = ["-c", "2", "-s", "3", "--schedule", "channel", "--prescreen", "8",
           "--prescreen-full", "2"]
# Three steps of the window's run reach its first windowed step (two
# exhaustive sweeps come first).
CASES = {
    "prescreen_pre": ["--prescreen-pre", "12", "--steps", "1"],
    "dither_proxy": ["-d", "--dither-proxy", "4", "--steps", "1"],
    "channel_window": ["--channel-window", "2", "--steps", "3"],
    "gate_coarse": ["--gate-margin", "0.01", "--gate-coarse", "--steps",
                    "1"],
}


@pytest.fixture(scope="module")
def src_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("src") / "src.png"
    Image.fromarray(bench_image(0), "RGBA").save(path)
    return path


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


def _step_errors(log):
    return [float(ln.rsplit(" ", 1)[1]) for ln in log
            if "] step " in ln and "error:" in ln]


def _run(main, src, out, flags, capture, **kw):
    """(sha256 of the JSON bytes, step errors) of one CLI run; `capture()`
    returns what the run printed."""
    capture()
    assert main([str(src), str(out), *CHANNEL, *flags], **kw) == 0
    steps = _step_errors(capture().splitlines())
    return hashlib.sha256(out.read_bytes()).hexdigest(), steps


@pytest.mark.parametrize("case", list(CASES))
def test_option_flags_write_the_jax_clis_json(src_png, tmp_path, capsys,
                                              one_torch_thread, case):
    """One option on the CHANNEL recipe: the JAX CLI's JSON bytes and its
    step errors within 1e-3."""
    want = json.loads(FROZEN.read_text())[case]
    flags = CASES[case]
    assert want["flags"] == flags
    digest, steps = _run(tcli.main, src_png, tmp_path / "out.json", flags,
                         lambda: capsys.readouterr().out, device="cpu")
    assert len(steps) == len(want["steps"]) == int(flags[-1])
    np.testing.assert_allclose(steps, want["steps"], rtol=0, atol=1e-3)
    assert digest == want["json_sha256"]


def freeze() -> None:
    """Runs the JAX CLI on every case and writes FROZEN."""
    import contextlib
    import io
    import tempfile

    import snesimage_tpu.cli as jcli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "src.png"
        Image.fromarray(bench_image(0), "RGBA").save(src)
        for case, flags in CASES.items():
            buf = io.StringIO()

            def capture():
                text = buf.getvalue()
                buf.seek(0)
                buf.truncate()
                return text

            with contextlib.redirect_stdout(buf):
                digest, steps = _run(jcli.main, src, Path(tmp) / "out.json",
                                     flags, capture)
            out[case] = dict(flags=flags, json_sha256=digest, steps=steps)
    FROZEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--freeze"]:
        sys.exit("usage: python tests/test_torch_cli_options.py --freeze")
    freeze()
