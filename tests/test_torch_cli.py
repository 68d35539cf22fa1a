"""The port's command lines (snesimage_torch/cli.py, batch_cli.py) and
their files (io/image.py, io/checkpoint.py, io/json_out.py, preview.py)
against the JAX package's, on the CPU (`main(..., device="cpu")`).

The parsers, profiles and merging functions are copies (importing the JAX
package would import JAX), so the first tests pin them to the originals.
The CLIs run at their fixed 256x256 with `--skip-optimize` or `--steps 0`
(init only), where the two packages' outputs must be equal byte for byte.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch
from PIL import Image

import snesimage_torch.batch_cli as tbcli
import snesimage_torch.cli as tcli
import snesimage_tpu.batch_cli as jbcli
import snesimage_tpu.cli as jcli
from snesimage_torch.io.checkpoint import (
    load_checkpoint as t_load,
    save_checkpoint as t_save,
)
from snesimage_torch.testing import bench_image, single_torch_thread
from snesimage_tpu.io.checkpoint import (
    load_checkpoint as j_load,
    save_checkpoint as j_save,
)


def _actions(parser):
    return [
        (a.dest, tuple(a.option_strings), a.default, a.type, a.choices,
         a.nargs, a.metavar, a.help, type(a).__name__)
        for a in parser._actions if a.dest not in ("help", "version")
    ]


@pytest.mark.parametrize("pair", [(tcli, jcli), (tbcli, jbcli)])
def test_parsers_are_the_jax_packages(pair):
    mine, theirs = pair
    assert _actions(mine.build_parser()) == _actions(theirs.build_parser())


def test_profiles_are_the_jax_packages():
    assert tcli.OPT_PROFILES == jcli.OPT_PROFILES


def _source(fn):
    return inspect.getsource(fn).replace("snesimage_tpu", "snesimage_torch")


@pytest.mark.parametrize("name", ["merge_geometry", "merge_opt_fields",
                                  "resolve_portfolio_k", "setup_logger",
                                  "_ColorFormatter"])
def test_copied_functions_are_verbatim(name):
    assert _source(getattr(tcli, name)) == _source(getattr(jcli, name))


def test_shard_paths_is_verbatim_and_agrees():
    assert _source(tbcli.shard_paths) == _source(jbcli.shard_paths)
    paths = [f"{i}.png" for i in range(11)]
    for hosts in (1, 2, 3, 4, 16):
        for host in range(hosts):
            assert (tbcli.shard_paths(paths, hosts, host)
                    == jbcli.shard_paths(paths, hosts, host))
    with pytest.raises(ValueError):
        tbcli.shard_paths(paths, 2, 2)


@pytest.mark.parametrize("argv", [
    [],
    ["--opt-profile", "balanced"],
    ["--opt-profile", "robust", "--steps", "3", "--portfolio", "4"],
    ["--preset", "nes-compat", "-c", "1", "--tol", "0.5"],
    ["--opt-profile", "quality", "--accept-margin", "0", "-d"],
])
def test_merged_configs_agree(argv):
    ta = tcli.build_parser().parse_args(["a", "b", *argv])
    ja = jcli.build_parser().parse_args(["a", "b", *argv])
    assert tcli.merge_geometry(ta) == jcli.merge_geometry(ja)
    assert tcli.merge_opt_fields(ta) == jcli.merge_opt_fields(ja)
    assert tcli.resolve_portfolio_k(ta) == jcli.resolve_portfolio_k(ja)


@pytest.fixture(scope="module")
def src_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("src") / "src.png"
    Image.fromarray(bench_image(0), "RGBA").save(path)
    return path


@pytest.fixture(scope="module")
def cli_outputs(src_png, tmp_path_factory):
    """Both CLIs on the same image and flags (init only), each writing its
    JSON, checkpoint and preview."""
    out = {}
    for name, main, kw in (("torch", tcli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        d = tmp_path_factory.mktemp(name)
        rc = main([str(src_png), str(d / "out.json"), "-c", "2", "-s", "3",
                   "--skip-optimize", "--checkpoint", str(d / "ck.npz"),
                   "--preview", str(d / "prev.png")], **kw)
        assert rc == 0
        out[name] = d
    return out


@pytest.mark.parametrize("name", ["out.json", "prev.png"])
def test_cli_files_equal_the_jax_clis(cli_outputs, name):
    """The JSON and the preview PNG are the JAX CLI's, byte for byte."""
    mine = (cli_outputs["torch"] / name).read_bytes()
    assert mine == (cli_outputs["jax"] / name).read_bytes()
    if name == "out.json":
        doc = json.loads(mine)
        assert len(doc["palette"]) == 32 and len(doc["tiles"]) == 1024


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoints_load_in_either_package(cli_outputs, writer):
    path = str(cli_outputs[writer] / "ck.npz")
    tstate, tconf, tmeta = t_load(path, device="cpu")
    jstate, jconf, jmeta = j_load(path)
    assert dataclasses.asdict(tconf) == dataclasses.asdict(jconf)
    assert tmeta == jmeta == {"errors": [], "step": 0}
    for f in ("original", "tile_palettes", "palette", "palette_map"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)


def test_checkpoint_roundtrip_with_errors(cli_outputs, tmp_path):
    """A checkpoint with a history, written by each package, reads back
    alike in the other, at exactly the path given."""
    state, config, _ = t_load(str(cli_outputs["torch"] / "ck.npz"), "cpu")
    jstate, jconfig, _ = j_load(str(cli_outputs["jax"] / "ck.npz"))
    t_save(str(tmp_path / "t.ckpt"), state, config, errors=[3.5, 2.25],
           step=2)
    j_save(str(tmp_path / "j.ckpt"), jstate, jconfig, errors=[3.5, 2.25],
           step=2)
    for name in ("t.ckpt", "j.ckpt"):
        a = t_load(str(tmp_path / name), "cpu")
        b = j_load(str(tmp_path / name))
        assert a[2] == b[2] == {"errors": [3.5, 2.25], "step": 2}
        assert torch.equal(a[0].palette_map, state.palette_map)
        np.testing.assert_array_equal(np.asarray(b[0].palette),
                                      state.palette.numpy())
    assert not list(tmp_path.glob("*.npz")) and not list(tmp_path.glob(
        "*.tmp"))


def test_portfolio_cli_path_equals_the_jax_clis(src_png, tmp_path, capsys):
    """`--opt-profile robust` takes the portfolio path (K = 2) and logs the
    seeds' finals; with no steps both packages write the init's JSON."""
    outs = []
    for name, main, kw in (("torch", tcli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        path = tmp_path / f"{name}.json"
        rc = main([str(src_png), str(path), "-c", "2", "-s", "3",
                   "--opt-profile", "robust", "--steps", "0"], **kw)
        assert rc == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert capsys.readouterr().out.count("portfolio: per-seed final errors") == 2


@pytest.mark.parametrize("flags", [
    ["--prescreen", "8", "--prescreen-pre", "12"],
    ["--dither-proxy", "4"],
    ["--channel-window", "2"],
    ["--gate-margin", "0.01", "--gate-coarse"],
])
def test_unported_flags_exit_1_and_name_their_item(src_png, tmp_path, capsys,
                                                   flags):
    """The four options the port leaves out (ROADMAP queue A item 17)."""
    out = tmp_path / "out.json"
    rc = tcli.main([str(src_png), str(out), *flags], device="cpu")
    assert rc == 1
    text = capsys.readouterr().out
    assert "ROADMAP queue A item 17" in text and "not ported" in text
    assert not out.exists()


# A deterministic recipe (channel sweeps, no explore draws) at 2x3, so the
# two CLIs' outputs can be compared byte for byte.
CHANNEL = ["-c", "2", "-s", "3", "--schedule", "channel", "--prescreen", "8",
           "--prescreen-full", "2"]
FAST = ["--opt-profile", "fast", "-c", "2", "-s", "3", "--steps", "2"]


@pytest.fixture
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with single_torch_thread():
        yield


def _lines(log, text):
    return [ln for ln in log if text in ln]


def _step_errors(log):
    return [float(ln.rsplit(" ", 1)[1]) for ln in _lines(log, "] step ")
            if "error:" in ln]


@pytest.mark.parametrize("case", [
    "fast", "gate_margin", "reassign_tiles", "verbose", "dump_every",
    "reassign_every", "resume", "hybrid", "profile_dir",
])
def test_host_stepped_flags_run_like_the_jax_cli(src_png, tmp_path, capsys,
                                                 one_torch_thread, case):
    """Each flag the port's CLI refused until the host-stepped loop, the
    gate, reassignment, resume, hybrid and tracing were ported runs on the
    CPU as the JAX CLI does: the same JSON bytes where no random draw
    enters, and the same log lines, mid-run files and warnings."""
    extra = {
        "fast": FAST,
        "gate_margin": [*CHANNEL, "--gate-margin", "0.01", "--steps", "1"],
        "reassign_tiles": [*FAST, "--reassign-tiles", "{d}/tiles.txt"],
        "verbose": [*CHANNEL, "-v", "--steps", "1"],
        "dump_every": [*CHANNEL, "--steps", "2", "--dump-every", "1",
                       "--checkpoint", "{d}/ck.npz"],
        # One step: the second step of this run meets a scale-1 near-tie
        # (ROADMAP C-9: visit 17 ranks candidates 24 and 25 apart within
        # float32 rounding), after which the packages keep other colours.
        "reassign_every": [*CHANNEL, "--steps", "1", "--reassign-every",
                           "1"],
        "resume": ["--resume", "{d}/start.npz", "--steps", "1",
                   "--prescreen", "4", "-d"],
        "hybrid": ["--opt-profile", "hybrid", "-c", "2", "-s", "3",
                   "--steps", "1"],
        "profile_dir": [*CHANNEL, "--steps", "0", "--profile-dir",
                        "{d}/prof"],
    }[case]
    runs = {}
    for name, main, kw in (("torch", tcli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        d = tmp_path / name
        d.mkdir()
        if case == "reassign_tiles":
            (d / "tiles.txt").write_text("# two clicks\n3 5\n0 0 1\n")
        if case == "resume":
            # An init-only checkpoint of the channel recipe.
            assert tcli.main([str(src_png), str(d / "init.json"), *CHANNEL,
                              "--skip-optimize", "--checkpoint",
                              str(d / "start.npz")], device="cpu") == 0
        capsys.readouterr()
        rc = main([str(src_png), str(d / "out.json"),
                   *(f.format(d=d) for f in extra)], **kw)
        runs[name] = (rc, d, capsys.readouterr().out.splitlines())
    (trc, td, tlog), (jrc, jd, jlog) = runs["torch"], runs["jax"]
    assert trc == jrc == 0
    steps, jsteps = _step_errors(tlog), _step_errors(jlog)
    assert len(steps) == len(jsteps)
    if case == "hybrid":
        # Phase 2 draws explore candidates, and the port's draws are its
        # own: the runs part there. Phase 1 (the gated fast recipe, one
        # step here) has none.
        assert len(steps) == 2 and abs(steps[0] - jsteps[0]) <= 1e-3
        out = json.loads((td / "out.json").read_text())
        assert len(out["palette"]) == 2 * 16 and len(out["tiles"]) == 1024
        return
    np.testing.assert_allclose(steps, jsteps, rtol=0, atol=1e-3)
    assert (td / "out.json").read_bytes() == (jd / "out.json").read_bytes()
    if case == "verbose":
        assert len(_lines(tlog, "] slot (")) == len(_lines(jlog, "] slot ("))
        assert len(_lines(tlog, "] slot (")) == 2 * 3 * 3
    if case == "dump_every":
        for text in ("Mid-run output written", "] step "):
            assert len(_lines(tlog, text)) == len(_lines(jlog, text))
        assert len(_lines(tlog, "Mid-run output written")) == 2
        assert t_load(str(td / "ck.npz"), "cpu")[2]["step"] == j_load(
            str(jd / "ck.npz"))[2]["step"] == 2
    if case == "reassign_every":
        assert len(_lines(tlog, "tiles reassigned")) == len(
            _lines(jlog, "tiles reassigned")) == 1
    if case == "reassign_tiles":
        assert len(_lines(tlog, "Applied 2 tile reassignments")) == 1
    if case == "resume":
        warn = [ln.split("] ", 1)[1] for ln in _lines(tlog, "WARNING")]
        assert warn == [ln.split("] ", 1)[1] for ln in _lines(jlog, "WARNING")]
        assert "ignoring --prescreen, -d" in warn[0]
    if case == "profile_dir":
        assert (td / "prof" / "trace.json").exists()
        assert any((jd / "prof").iterdir())


def test_wrong_size_exits_1(tmp_path):
    path = tmp_path / "small.png"
    Image.fromarray(bench_image(0)[:64, :64], "RGBA").save(path)
    assert tcli.main([str(path), str(tmp_path / "o.json")],
                     device="cpu") == 1


@pytest.fixture
def two_images(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    for s in range(2):
        Image.fromarray(bench_image(s + 1), "RGBA").save(indir / f"im{s}.png")
    return indir


def test_batch_cli_writes_the_jax_batch_clis_json(two_images, tmp_path):
    """Init-only batches (`--steps 0`) of the `nes-compat` preset: every
    <stem>.json equals the JAX batch CLI's, byte for byte."""
    for name, main, kw in (("torch", tbcli.main, {"device": "cpu"}),
                           ("jax", jbcli.main, {})):
        rc = main([str(two_images), str(tmp_path / name), "--preset",
                   "nes-compat", "--steps", "0"], **kw)
        assert rc == 0
    for s in range(2):
        mine = (tmp_path / "torch" / f"im{s}.json").read_bytes()
        assert mine == (tmp_path / "jax" / f"im{s}.json").read_bytes()


@pytest.mark.parametrize("argv,rc", [
    (["--host-id", "1"], 1), (["--limit", "0"], 1),
    (["--num-hosts", "4", "--host-id", "3"], 0),
    (["--opt-profile", "robust"], 1), (["--opt-profile", "hybrid"], 1),
])
def test_batch_cli_guards_match_the_jax_batch_cli(two_images, tmp_path, argv,
                                                  rc):
    """Fail-fast guards exit as the JAX batch CLI's do, before any work:
    a lone --host-id, a bad --limit, robust and hybrid; an empty shard is
    a clean exit 0 (2 images over 4 hosts leave host 3 none)."""
    for name, main, kw in (("torch", tbcli.main, {"device": "cpu"}),
                           ("jax", jbcli.main, {})):
        out = tmp_path / name
        assert main([str(two_images), str(out), *argv], **kw) == rc
        assert not out.exists() or not list(out.glob("*.json"))


def test_batch_cli_stem_collision(two_images, tmp_path):
    Image.fromarray(bench_image(0)[..., :3], "RGB").save(two_images / "im0.jpg")
    for name, main, kw in (("torch", tbcli.main, {"device": "cpu"}),
                           ("jax", jbcli.main, {})):
        assert main([str(two_images), str(tmp_path / name), "--steps",
                     "0"], **kw) == 1


def test_batch_cli_gate_is_inert(two_images, tmp_path, capsys):
    """`--opt-profile fast` in batch mode logs that the gate is inert and
    runs exactly, where the single-image CLI refuses the gate."""
    rc = tbcli.main([str(two_images), str(tmp_path / "o"), "--preset",
                     "nes-compat", "--opt-profile", "fast", "--steps", "0"],
                    device="cpu")
    assert rc == 0
    assert "inert in batch mode" in capsys.readouterr().out
    assert len(list((tmp_path / "o").glob("*.json"))) == 2
