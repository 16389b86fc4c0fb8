"""The harness on the CPU: what it imports, how it finds a cell's pieces by name,
its refusal to run without a CUDA device, the reading of a trace, and the check
of ``correct`` against its control and the faults a training cell can have.

The runs here drive the whole of ``harness.run_cell`` but the look for a chip,
at the port's smoke sizes on the CPU, against each cell's own limits."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from onchip_bench import check, harness, spec, trace
from onchip_bench.tests import tiny
from repro_torch.train import steps

ROOT = Path(__file__).resolve().parents[2]
SEED = 3_000_000_017


def _python(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run loads (the harness, every piece of every cell, a run
    at smoke size) leaves no top-level ``jax``, ``jaxlib``, ``flax`` or ``repro``
    in ``sys.modules``; ``repro_torch`` is not ``repro``."""
    loaded = _python("""
        import json, sys, time
        from onchip_bench import harness, spec
        from onchip_bench.tests import tiny
        bench = spec.load_benchmark()
        for w in bench["workloads"]:
            c = spec.resolve(bench, w["name"])
            for kind in ("reference", "port", "work"):
                spec.module(kind, c.config)
            for m in c.end_to_end + c.per_layer:
                spec.module("metrics", m)
        harness.run_cell(tiny.cell(tiny.MB_CELL), 5, 0.1, False, "cpu", "/tmp",
                         time.perf_counter())
        tops = sorted({m.split(".")[0] for m in sys.modules})
        print(json.dumps([harness.forbidden_modules(), "repro_torch" in tops]))
    """)
    assert loaded == [[], True]


def test_the_references_load_nothing_of_the_program():
    tops = _python("""
        import json, sys
        from onchip_bench import spec
        for name in ("deepseek-v2-lite-16b.dense1-moe3", "mamba2-780m"):
            spec.module("reference", name)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert harness.forbidden_modules() == ["repro"]


def _copy_bench(tmp_path: Path) -> Path:
    shutil.copytree(spec.BENCH, tmp_path / "onchip_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path / "onchip_bench"


def test_a_new_cell_config_and_metric_are_found_by_their_files(tmp_path):
    """Added as new files and new entries only: a configuration (a copy of
    mamba2-780m under another name), a traffic mix, the cell's limits and a
    per-layer metric's reader."""
    bench = _copy_bench(tmp_path)
    for kind, suffix in (("configs", ".json"), ("reference", ".py"), ("port", ".py"),
                         ("work", ".py")):
        shutil.copy(bench / kind / f"mamba2-780m{suffix}", bench / kind / f"mamba2-copy{suffix}")
    (bench / "traffic" / "train.2x512.json").write_text(
        (bench / "traffic" / "train.8x2048.json").read_text().replace('"batch": 8', '"batch": 2')
        .replace('"seq_len": 2048', '"seq_len": 512'))
    shutil.copy(bench / "limits" / "train.mamba2-780m.8x2048.json",
                bench / "limits" / "train.mamba2-copy.2x512.json")
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.window['steps']\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "train.mamba2-copy.2x512", "config": "mamba2-copy",
                             "traffic": "train.2x512", "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "train step",
                             "moves": "train_tokens_per_s",
                             "workloads": ["train.mamba2-copy.2x512"]})
    cell = spec.resolve(doc, "train.mamba2-copy.2x512", bench)
    assert cell.traffic["seq_len"] == 512 and cell.conf["n_layer"] == 48
    assert "steps_in_window" in cell.per_layer and "mfu" not in cell.per_layer
    assert cell.end_to_end == ("train_tokens_per_s", "peak_gb", "setup_s")
    assert spec.module("metrics", "steps_in_window", bench).read(
        type("Ctx", (), {"window": {"steps": 7}})) == 7


def test_a_workload_whose_config_file_is_missing_is_refused(tmp_path):
    bench = _copy_bench(tmp_path)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "train.nothing.8x2048", "config": "nothing",
                             "traffic": "train.8x2048", "chips": 1, "why": "a test"})
    with pytest.raises(spec.MissingPiece, match="nothing"):
        spec.resolve(doc, "train.nothing.8x2048", bench)
    with pytest.raises(spec.MissingPiece):
        spec.resolve(doc, "train.not-listed.8x2048", bench)


def test_without_a_cuda_device_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "onchip_bench/run.py", "--workload", tiny.MB_CELL,
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_prebuild_builds_what_the_port_loads():
    """The child process of ``prebuild.py`` builds each library under the name
    and in the directory where the port's own loader looks for it, so that the
    timed process finds it built."""
    from onchip_bench import prebuild
    from repro_torch.kernels import _build

    b = prebuild.builder()
    assert b.build_dir() == _build.build_dir() and b.NVCC_FLAGS == _build.NVCC_FLAGS
    sources = sorted(_build.CSRC_DIR.glob("*.cu"))
    assert {"flash_attention.cu", "flash_attention_bwd.cu", "ssd_scan.cu",
            "ssd_scan_bwd.cu"} <= {cu.name for cu in sources}
    for cu in sources:
        stem, text = b.csrc_source(cu.name)
        assert (stem, text) == _build.csrc_source(cu.name)
        assert b.source_hash(text) == _build.source_hash(text)


def test_reading_a_trace():
    """Device activity [0, 10) and [30, 40) µs and a kernel at [35, 50) in a
    stretch of [0, 100): busy 30 µs; the gaps [10, 30) and [50, 100) are named
    by the innermost host operation at their middles."""
    ev = [{"ph": "X", "name": trace.STRETCH, "cat": "user_annotation", "ts": 0, "dur": 100},
          {"ph": "X", "name": "flash_bf16_wgmma<192, 128, false>", "cat": "kernel", "ts": 0,
           "dur": 10},
          {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 30, "dur": 10},
          {"ph": "X", "name": "flash_bwd_delta", "cat": "kernel", "ts": 35, "dur": 15},
          {"ph": "X", "name": trace.STEP, "cat": "user_annotation", "ts": 0, "dur": 90},
          {"ph": "X", "name": "aten::nonzero", "cat": "cpu_op", "ts": 15, "dur": 10},
          {"ph": "X", "name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 18, "dur": 4}]
    s = trace.read_events(ev, steps=1)
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(30e-6)
    assert [n for n, _ in s.kernels] == ["flash_bf16_wgmma<192, 128, false>", "flash_bwd_delta"]
    assert [t for _, t in s.kernels] == pytest.approx([10e-6, 15e-6])
    assert dict(s.idle_gaps) == pytest.approx({"cudaStreamSynchronize": 20e-6,
                                               trace.STEP: 50e-6})
    work = {"k3": (989e12 * 5e-6, 0.0), "s2": (0.0, 3.35e12 * 3e-6)}
    assert trace.roofline_pct(s, work, ("k3", "s2"), 989e12, 3.35e12) == pytest.approx(
        100 * 8 / 25)
    with pytest.raises(RuntimeError, match="K5"):
        trace.roofline_pct(s, work, ("k3", "k5"), 989e12, 3.35e12)
    with pytest.raises(RuntimeError, match="no device activity"):
        trace.read_events([e for e in ev if e["cat"] not in trace.DEVICE_CATS], steps=1)


# -- correct: the sound run, its control and the faults -----------------------

CELLS = [tiny.DS_CELL, tiny.MB_CELL]


def _run(name: str) -> dict:
    return harness.run_cell(tiny.cell(name), SEED, 0.1, False, "cpu", "/tmp", 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(check.NUMBERS)


def _broken(monkeypatch, fault: str):
    real = steps.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)
        if fault == "unchanged":
            return lambda state, batch: (state, step(state, batch)[1])
        return lambda state, batch: step(state, harness.half_masked(batch))

    monkeypatch.setattr(steps, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    r = _run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_the_program(name):
    """The control, the reference computed in fp8 in the program's place, reads
    ``grad_dist`` at three times the program's or more at this size too (on the
    chip, at the cells' own sizes, its readings set the limits: ``PERF.md``)."""
    c = tiny.cell(name)
    program = _run(name)["checks"]["grad_dist"]["value"]
    found = check.gaps(harness.reference(c, SEED, torch.device("cpu"), "fp8"),
                       harness.reference(c, SEED, torch.device("cpu")))
    assert found["grad_dist"] >= 3 * program, (found["grad_dist"], program)
