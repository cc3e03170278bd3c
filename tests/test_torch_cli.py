"""The port's CLI (``python -m dbde_tpu_torch.cli``) against the JAX
package's, on the CPU.

Every subcommand runs in-process, on both sides with ``--no-device``: the
JAX CLI then runs its numpy oracle (no JAX compile) and the port its plain
PyTorch versions.  The JAX CLI's ``preview`` is host-only and has no such
flag; the port's runs on the card unless given it.  Files, raw frames, PGMs, stdout, stderr and exit codes
must be equal (tolerance 0: the codec is integer-valued).  Also: the device
commands raise without a GPU, ``bench`` dispatches as the JAX CLI does,
and a rehearsal of ``chip_smoke.py``'s phase 6 at a tiny size.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from dbde_tpu import bench_core as jax_bench
from dbde_tpu import cli as jax_cli
from dbde_tpu_torch import bench_core, cli
from dbde_tpu_torch.bench_core import make_adversarial, make_content

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (frames, batch): 3 frames of 24x40, and 2 ragged frames of 19x27
GEOMETRIES = {
    "24x40": lambda: make_content(40, 24, 3),
    "19x27 ragged": lambda: make_adversarial(27, 19, 2, maxd=8, seed=3),
}


def _run(main, argv, capsys):
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _port_argv(argv):
    """The JAX CLI's argv for the port: ``preview`` asks for the CPU."""
    return [*argv, "--no-device"] if argv[0] == "preview" else argv


@pytest.fixture(params=list(GEOMETRIES))
def video(request, tmp_path):
    """(frames, raw path, the JAX CLI's encoded file)."""
    frames = GEOMETRIES[request.param]()
    raw = tmp_path / "in.raw"
    frames.tofile(raw)
    enc = tmp_path / "jax.dbde"
    N, H, W = frames.shape
    assert jax_cli.main(["encode", str(raw), "-o", str(enc), "--width", str(W),
                         "--height", str(H), "--hz", "30", "--batch", "2", "--no-device"]) == 0
    return frames, raw, enc


def test_encode_byte_equal(video, tmp_path, capsys):
    frames, raw, enc = video
    N, H, W = frames.shape
    ours = tmp_path / "port.dbde"
    rc, out, _ = _run(cli.main, ["encode", raw, "-o", ours, "--width", W, "--height", H,
                                 "--hz", 30, "--batch", 2, "--no-device"], capsys)
    assert rc == 0 and out.startswith(f"encoded {N} frames")
    assert ours.read_bytes() == enc.read_bytes()


def test_decode_raw_and_pgm_equal(video, tmp_path, capsys):
    frames, raw, enc = video
    for main, name in ((jax_cli.main, "jax"), (cli.main, "port")):
        rc, out, _ = _run(main, ["decode", enc, "-o", tmp_path / f"{name}.raw",
                                 "--pgm-dir", tmp_path / f"{name}_pgm", "--batch", 2,
                                 "--no-device"], capsys)
        assert rc == 0 and out.startswith(f"decoded {len(frames)} frames")
    assert (tmp_path / "port.raw").read_bytes() == raw.read_bytes() == \
        (tmp_path / "jax.raw").read_bytes()
    names = sorted(os.listdir(tmp_path / "jax_pgm"))
    assert names == sorted(os.listdir(tmp_path / "port_pgm")) and len(names) == len(frames)
    for name in names:
        assert (tmp_path / "port_pgm" / name).read_bytes() == \
            (tmp_path / "jax_pgm" / name).read_bytes()


@pytest.mark.parametrize("args", [["info"], ["info", "--scan"], ["preview"],
                                  ["preview", "--frame", "1", "--size", "8"],
                                  ["roundtrip", "--no-device"]])
def test_host_commands_print_the_same(video, args, capsys):
    frames, raw, enc = video
    argv = [args[0], enc, *args[1:]]
    want = _run(jax_cli.main, argv, capsys)
    assert _run(cli.main, _port_argv(argv), capsys) == want
    assert want[0] == 0 and want[1]


def test_preview_every_frame_matches_jax(video, capsys):
    """Each frame, and the first past the end, as the JAX CLI previews it:
    the port walks the records before it undecoded and decodes one."""
    frames, raw, enc = video
    for i in range(len(frames) + 1):
        argv = ["preview", enc, "--frame", i, "--size", 4]
        want = _run(jax_cli.main, argv, capsys)
        assert _run(cli.main, _port_argv(argv), capsys) == want
        assert want[0] == (0 if i < len(frames) else 1)


@pytest.mark.parametrize("frames", [1, 3])
def test_golden_equal(frames, tmp_path, capsys):
    path = tmp_path / "g.dbde"
    want = _run(jax_cli.main, ["golden", "-o", path, "--frames", frames], capsys)
    want_bytes = path.read_bytes()
    path.unlink()
    assert _run(cli.main, ["golden", "-o", path, "--frames", frames], capsys) == want
    assert path.read_bytes() == want_bytes


def test_roundtrip_mismatch_equal(video, capsys):
    frames, raw, enc = video
    with open(enc, "ab") as f:  # trailing bytes: the re-encode cannot equal the file
        f.write(b"\x00" * 5)
    want = _run(jax_cli.main, ["roundtrip", enc, "--no-device"], capsys)
    assert _run(cli.main, ["roundtrip", enc, "--no-device"], capsys) == want
    assert want[0] == 1 and want[2].startswith("MISMATCH")


@pytest.mark.parametrize("case", ["encode size", "preview frame", "info header"])
def test_error_paths_equal(case, tmp_path, capsys):
    raw = tmp_path / "in.raw"
    make_content(40, 24, 2).tofile(raw)
    enc = tmp_path / "v.dbde"
    assert jax_cli.main(["encode", str(raw), "-o", str(enc), "--width", "40", "--height", "24",
                         "--no-device"]) == 0
    capsys.readouterr()
    if case == "encode size":
        argv = ["encode", raw, "-o", tmp_path / "x.dbde", "--width", 41, "--height", 24,
                "--no-device"]
    elif case == "preview frame":
        argv = ["preview", enc, "--frame", 9]
    else:
        bad = tmp_path / "bad.dbde"
        bad.write_bytes(b"\x07" + enc.read_bytes()[1:])
        argv = ["info", bad]
    want = _run(jax_cli.main, argv, capsys)
    assert _run(cli.main, _port_argv(argv), capsys) == want
    assert want[0] == 1 and want[2] and not want[1]


@pytest.mark.parametrize("cmd", ["encode", "decode", "roundtrip", "preview"])
def test_device_commands_raise_without_gpu(cmd, video, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the error without one")
    frames, raw, enc = video
    N, H, W = frames.shape
    out = tmp_path / "out.dbde"
    argv = {"encode": ["encode", raw, "-o", out, "--width", W, "--height", H],
            "decode": ["decode", enc, "-o", out],
            "roundtrip": ["roundtrip", enc],
            "preview": ["preview", enc]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(a) for a in argv])
    assert not out.exists()


RUNNERS = ("run_bench", "run_stream_bench", "run_composed_stream_bench", "run_latency_bench",
           "run_host_stream_bench")


@pytest.mark.parametrize("flags, runner", [
    ([], "run_bench"),
    (["--content", "random", "--iters", "3", "--frames", "2"], "run_bench"),
    (["--stream", "--frames", "5", "--batch", "2", "--repeats", "3", "--content", "flat"],
     "run_stream_bench"),
    (["--host-stream", "--width", "64", "--height", "8"], "run_host_stream_bench"),
    (["--composed", "--batch", "4"], "run_composed_stream_bench"),
    (["--latency", "--content", "random"], "run_latency_bench"),
    (["--composed", "--latency", "--host-stream", "--stream"], "run_composed_stream_bench"),
    (["--latency", "--host-stream", "--stream"], "run_latency_bench"),
    (["--host-stream", "--stream"], "run_host_stream_bench"),
])
def test_bench_dispatches_as_jax(flags, runner, monkeypatch, capsys):
    """The port's bench calls the runner the JAX CLI calls, with the JAX
    CLI's keyword arguments and ``device="cuda"`` (none for the host-only
    walker), and prints its result as one JSON line."""
    calls = {}
    for mod, side in ((jax_bench, "jax"), (bench_core, "port")):
        for name in RUNNERS:
            def fake(_name=name, _side=side, **kw):
                calls[_side] = (_name, kw)
                return {"runner": _name}
            monkeypatch.setattr(mod, name, fake)
    for main in (jax_cli.main, cli.main):
        assert main(["bench", *flags]) == 0
        assert capsys.readouterr().out == f'{{"runner": "{runner}"}}\n'
    name, kw = calls["port"]
    assert name == calls["jax"][0] == runner
    want = dict(calls["jax"][1])
    if runner != "run_host_stream_bench":
        want["device"] = "cuda"
    assert kw == want


def test_chip_smoke_cli_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 6's file commands of chip_smoke.py at tiny sizes with --no-device."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.check_cli(str(tmp_path), [(40, 24, "camera"), (40, 24, "random"),
                                               (27, 19, "camera"), (64, 8, "flat")],
                               pgm_geometry=2, device_args=("--no-device",))
    assert set(launches.values()) == {0}
