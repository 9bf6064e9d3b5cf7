"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points run on CUDA unless the CPU is asked for (and raise
without CUDA), flags of features not yet ported say so, and a kernel
wrapper given a tensor off the CPU launches its kernel or raises — it never
falls back to the plain version."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.duet_attention import (duet_attention,
                                                duet_attention_paged)
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.launch import serve, train
from repro_torch.models import Model
from repro_torch.serving import DuetEngine, EngineConfig

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "decode_core_sweep.py",
    REPO / "flash_prefill_sweep.py", REPO / "duet_paged_sweep.py",
    REPO / "train_check_floor.py", REPO / "pace_probe.py",
    REPO / "kernel_turns.py", REPO / "block_role_sweep.py"]


def test_cli_serves_on_cpu_without_jax_or_reference():
    """The serve CLI in a fresh interpreter: every request finishes, and
    neither ``jax`` nor ``repro`` was ever imported."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--reduced', '--device', 'cpu', '--stream',\n"
        "            '--num-requests', '4', '--max-len', '128',\n"
        "            '--attn-kernel']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    finishes = [json.loads(ln) for ln in lines
                if ln.startswith('{"event": "finish"')]
    assert sorted(f["rid"] for f in finishes) == [0, 1, 2, 3]
    summary = json.loads(proc.stdout[proc.stdout.index("\n{\n") + 1:])
    assert summary["num_finished"] == 4
    assert summary["kernel_path"] == "torch"
    assert summary["device"] == {"type": "cpu", "count": 1}
    st = summary["dispatch_stats"]
    assert 0 < st["host_syncs"] <= st["super_iterations"]


def test_train_cli_trains_on_cpu_without_jax_or_reference():
    """The train CLI in a fresh interpreter, with the training, data and
    launch modules imported: a few steps on the CPU, and neither ``jax``
    nor ``repro`` was ever imported."""
    code = (
        "import runpy, sys\n"
        "import repro_torch.training, repro_torch.data\n"
        "import repro_torch.training.checkpoint, repro_torch.launch.train\n"
        "sys.argv = ['train', '--reduced', '--device', 'cpu', '--steps',\n"
        "            '3', '--batch', '2', '--seq', '16']\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2"], lines


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_without_cuda(no_cuda):
    cfg = reduced(get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.init(cfg)
    model = Model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DuetEngine(model, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--num-requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flags", [
    ["--tp", "2", "--dp", "2"],
])
def test_unported_flags_exit(flags, no_cuda):
    """No serve flag is refused as unported any more: DP x TP places its
    ranks itself, and on a missing card it raises before spawning any,
    never moving to the CPU quietly."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", *flags])
    with pytest.raises(SystemExit, match="places its ranks itself"):
        serve.main(["--reduced", "--device", "mps", *flags])


# the serve CLI's data-parallel and load-generator flags on the CPU: 4
# requests of the reduced config each; (flags, what the run must show:
# "router" routed requests and the replicas' summaries, "scale" an up
# and a down event, "prefix" cross-request prefix hits)
ELASTIC_FLAGS = ["--elastic", "--scale-up-tokens", "40",
                 "--scale-down-tokens", "30", "--scale-cooldown", "0.001",
                 "--scale-interval", "0.001"]


@pytest.fixture
def one_thread():
    """One torch thread for an in-process CLI run of the reduced model:
    with the suite's parallel workers sharing the cores, torch's default
    thread team per op slows it by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags,shows", [
    (["--dp", "2"], {"router"}),
    (["--dp", "2", "--router-policy", "prefix", "--shared-prefix-len", "32",
      "--stream"], {"router", "prefix"}),
    (ELASTIC_FLAGS + ["--stream"], {"router", "scale"}),
    (["--arrival", "mmpp"], set()),
    (["--service-mix", "mixture", "--stream"], set()),
    (["--rho", "0.5", "--dp", "2", "--router-policy", "least-loaded"],
     {"router"}),
], ids=["dp", "prefix", "elastic", "mmpp", "mixture", "rho"])
def test_dp_and_load_flags_serve_on_cpu(flags, shows, capsys, one_thread):
    serve.main(["--reduced", "--device", "cpu", "--num-requests", "4",
                "--max-len", "128", *flags])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{\n"):])
    events = [json.loads(ln) for ln in out[:out.index("{\n")].splitlines()]
    assert summary["num_finished"] == summary["num_requests"] == 4
    if "--stream" in flags:
        finished = sorted(e["rid"] for e in events
                          if e["event"] == "finish")
        assert finished == [0, 1, 2, 3]
    if "router" in shows:
        router = summary["router"]
        assert router["routed_requests"] >= 4
        assert sum(router["dispatch_counts"]) == router["routed_requests"]
        assert len(summary["per_replica"]) == summary["mesh"]["dp"] == 2
        if "--stream" in flags:
            assert sum(e["event"] == "router" for e in events) == \
                router["routed_requests"]
    else:
        assert "router" not in summary and summary["mesh"]["dp"] == 1
    if "scale" in shows:
        scale = [(e["action"], e["replica"]) for e in events
                 if e["event"] == "scale"]
        assert ("up", 1) in scale and ("down", 1) in scale
        elastic = summary["router"]["elastic"]
        assert elastic["scale_ups"] >= 1 and elastic["scale_downs"] >= 1
    if "prefix" in shows:
        assert summary["prefix_cache"]["hit_tokens"] > 0
        assert summary["router"]["prefix_routed_tokens"] > 0


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card (here the
    meta device) is refused, not served by the plain version."""
    q = torch.empty((2, 4, 64), device="meta")
    pages = torch.empty((8, 16, 2, 64), device="meta")
    tables = torch.empty((2, 4), dtype=torch.int32, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="is not on"):
        paged_decode(q, pages, pages, tables, lengths)
    with pytest.raises(ValueError, match="is not on"):
        duet_attention_paged(q, lengths[:, None], lengths, pages, pages,
                             tables, block_q=1)
    with pytest.raises(ValueError, match="is not on"):
        duet_attention(q, lengths[:, None], lengths, pages, pages,
                       block_q=1, block_k=16)
    seq = torch.empty((1, 16, 4, 64), device="meta")
    with pytest.raises(ValueError, match="is not on"):
        flash_prefill(seq, pages[:1, :, :2], pages[:1, :, :2])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def _c_entries(source: str):
    """The functions defined inside the ``extern "C"`` blocks of a CUDA
    source (each returns int: a CUDA error code)."""
    names = []
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"',
                            source, flags=re.S):
        names += re.findall(r"^int\s+(\w+)\s*\(", block, flags=re.M)
    return names


def test_every_c_entry_has_a_signature_and_every_signature_an_entry():
    """_build.SIGNATURES sets the ctypes argtypes of every C entry point:
    an entry without a row would be called with ctypes' default int
    arguments (cutting 64-bit pointers), a row without an entry fails at
    load. Every built source is listed, and every source is built."""
    sources = {p.stem: p.read_text() for p in _build.CSRC.glob("*.cu")}
    assert set(sources) == set(_build.SOURCES) == set(_build.SIGNATURES)
    for name, text in sources.items():
        entries = _c_entries(text)
        assert entries, f"{name}.cu has no extern \"C\" entry"
        assert len(entries) == len(set(entries)), entries
        assert set(entries) == set(_build.SIGNATURES[name]), name
