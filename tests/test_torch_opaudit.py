"""opaudit on the port (``transmogrifai_tpu_torch/analysis``).

The JAX package's ``tests/test_opaudit.py`` case for case through
``tests/torch_mirror.py``: the seeded trees take port paths (the
rewrite points every ``transmogrifai_tpu`` at ``transmogrifai_tpu_torch``),
and the real-tree cases (the full audit with zero unsuppressed
findings, the deterministic JSON report, the acyclic lock graph, the
concurrency pass clean, the real metrics module and fault catalog)
audit the port's tree. Then port-written cases for what the port
changed: the ``trace-env`` roots (``lru_cache`` bodies,
``torch.compile`` / ``torch.jit`` / CUDA-graph targets, the kernels'
build), the bench registry over ``bench_gpu.py`` with no capture
daemon, the CLI's exit codes, and the waivers the port carries for the
same code as the JAX package.

SKIP names each JAX case left out and why.
"""
import json
import os
import subprocess
import sys

import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,  # noqa
                          run_mirror_case)
from transmogrifai_tpu_torch.analysis import (__main__ as cli, core,
                                              surfaces, trace_env)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIRROR = load_mirror("test_opaudit.py")
globals().update(mirror_fixtures(MIRROR))

#: case id -> why the port does not run it as the JAX test wrote it
SKIP = {
    "test_trace_env_catches_env_read_reached_from_jit":
        "its root is jax.jit, which the port has no counterpart of; "
        "the port's roots are held by test_trace_env_* below",
    "test_trace_env_resolves_package_init_reexports":
        "a jax.jit root; the same re-export case through an lru_cache "
        "root is test_trace_env_resolves_package_init_reexports below",
    "test_trace_env_catches_decorated_and_module_global_forms":
        "an @jax.jit root; the @torch.compile and @lru_cache forms are "
        "test_trace_env_catches_decorated_and_module_global_forms below",
    "test_surface_registry_catches_each_drift_axis":
        "seeds bench.py and tpu_capture.PRIORITY; the port's registry "
        "is bench_gpu.py with no capture daemon "
        "(test_surface_registry_catches_each_bench_gpu_drift_axis)",
    "test_surface_registry_silent_on_consistent_registries":
        "seeds bench.py and tpu_capture.py; the port's counterpart is "
        "test_surface_registry_silent_on_a_consistent_bench_gpu",
}


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MIRROR) if p.id not in SKIP])
def test_opaudit_case_on_the_port(name, kwargs, request):
    run_mirror_case(MIRROR, name, kwargs, request)


@pytest.fixture(scope="module")
def real_ctx():
    """One parse of the port's tree for the real-tree cases below."""
    return core.load_context(_REPO)


def _ctx(tmp_path, files, docs=None):
    for rel, text in (docs or {}).items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return core.AuditContext(str(tmp_path), [core.SourceFile(rel, text)
                                             for rel, text in files.items()])


def _codes(findings):
    return [d.code for d in findings]


# ---------------------------------------------------------------------------
# trace-env: the port's frozen-decision roots
# ---------------------------------------------------------------------------

_POLICY = ("import os\n"
           "def policy():\n"
           "    return os.environ.get('TM_FAKE_POLICY') == '1'\n")


@pytest.mark.parametrize("root", [
    "import functools\n@functools.lru_cache(maxsize=None)\n"
    "def kernel(x):\n    return x + 1 if policy() else x\n",
    "import functools\n@functools.cache\n"
    "def kernel(x):\n    return x + 1 if policy() else x\n",
    "import torch\n@torch.compile\n"
    "def kernel(x):\n    return x + 1 if policy() else x\n",
    "import torch\n@torch.compile(mode='max-autotune')\n"
    "def kernel(x):\n    return x + 1 if policy() else x\n",
    "import torch\ndef kernel(x):\n    return x + 1 if policy() else x\n"
    "def run(x):\n    return torch.compile(kernel)(x)\n",
    "import torch\ndef kernel(x):\n    return x + 1 if policy() else x\n"
    "def run(x):\n    return torch.jit.script(kernel)(x)\n",
    "import torch\ndef kernel(x):\n    return x + 1 if policy() else x\n"
    "def run(x):\n    return torch.jit.trace(kernel, (x,))(x)\n",
    "import torch\ndef kernel(x):\n    return x + 1 if policy() else x\n"
    "def run(x):\n"
    "    return torch.cuda.make_graphed_callables(kernel, (x,))(x)\n",
    "import functools\ndef kernel(x):\n    return x + 1 if policy() else x\n"
    "def run(x):\n    return functools.lru_cache(maxsize=8)(kernel)(x)\n",
    "import torch\ndef kernel(x):\n    return x + 1 if policy() else x\n"
    "def run(x, g):\n    with torch.cuda.graph(g):\n"
    "        y = kernel(x)\n    return y\n",
], ids=["lru_cache", "cache", "compile", "compile_call_decorator",
        "compile_call", "jit_script", "jit_trace", "graphed_callables",
        "lru_cache_call", "cuda_graph_block"])
def test_trace_env_catches_env_read_reached_from_a_frozen_root(tmp_path,
                                                               root):
    ctx = _ctx(tmp_path, {"transmogrifai_tpu_torch/fake.py": _POLICY + root})
    found = trace_env.run(ctx)
    assert _codes(found) == ["TM-AUDIT-301"], [d.message for d in found]
    assert "policy" in found[0].message
    assert found[0].location == "transmogrifai_tpu_torch/fake.py:3"


def test_trace_env_silent_on_resolved_argument_threading(tmp_path):
    """The knob resolved OUTSIDE the cached body and passed in as an
    argument (so the cache keys on it) is not a finding; neither is an
    env read outside a CUDA-graph block."""
    src = (_POLICY +
           "import functools\nimport torch\n"
           "@functools.lru_cache(maxsize=None)\n"
           "def kernel(x, use_policy):\n"
           "    return x + 1 if use_policy else x\n"
           "def run(x, g):\n"
           "    use = policy()\n"
           "    with torch.cuda.graph(g):\n"
           "        y = kernel(x, use)\n"
           "    return y\n")
    ctx = _ctx(tmp_path, {"transmogrifai_tpu_torch/fake.py": src})
    assert trace_env.run(ctx) == []


def test_trace_env_catches_a_read_inside_a_cuda_graph_block(tmp_path):
    src = ("import os\nimport torch\n"
           "def run(x, g):\n"
           "    with torch.cuda.graph(g):\n"
           "        y = x * float(os.environ.get('TM_FAKE_SCALE', '1'))\n"
           "    return y\n")
    ctx = _ctx(tmp_path, {"transmogrifai_tpu_torch/fake.py": src})
    found = trace_env.run(ctx)
    assert _codes(found) == ["TM-AUDIT-301"]
    assert found[0].location == "transmogrifai_tpu_torch/fake.py:5"


def test_trace_env_resolves_package_init_reexports(tmp_path):
    files = {
        "transmogrifai_tpu_torch/fakepkg/__init__.py":
            "from .impl import helper\n",
        "transmogrifai_tpu_torch/fakepkg/impl.py":
            "import os\n"
            "def helper():\n"
            "    return os.environ.get('TM_FAKE_REEXPORT')\n",
        "transmogrifai_tpu_torch/user.py":
            "import functools\n"
            "from .fakepkg import helper\n"
            "@functools.lru_cache(maxsize=None)\n"
            "def table(n):\n"
            "    return n if helper() else -n\n",
    }
    found = trace_env.run(_ctx(tmp_path, files))
    assert any(d.location.startswith(
        "transmogrifai_tpu_torch/fakepkg/impl.py") for d in found)


def test_trace_env_catches_decorated_and_module_global_forms(tmp_path):
    src = ("import os\nimport torch\n"
           "_KNOB = os.environ.get('TM_FAKE_GLOBAL')\n"
           "@torch.compile\n"
           "def f(x):\n"
           "    return x if _KNOB else -x\n")
    found = trace_env.run(_ctx(tmp_path,
                               {"transmogrifai_tpu_torch/fake2.py": src}))
    assert any("_KNOB" in d.message for d in found)


def test_trace_env_roots_at_the_kernels_build(tmp_path):
    """``_cuda_build.load_library`` is a root: an env read it reaches
    (here a fake build directory) is a finding."""
    files = {
        "transmogrifai_tpu_torch/_cuda_build.py":
            "from ._dirs import where\n"
            "def load_library(name):\n"
            "    return where() + name\n",
        "transmogrifai_tpu_torch/_dirs.py":
            "import os\n"
            "def where():\n"
            "    return os.environ.get('TM_FAKE_DIR', '/x')\n",
    }
    found = trace_env.run(_ctx(tmp_path, files))
    assert [d.location for d in found] == ["transmogrifai_tpu_torch/_dirs.py:3"]
    assert "load_library" in found[0].message


def test_real_tree_trace_env_findings_are_the_waived_build_reads(real_ctx):
    """On the port's tree the pass reaches the kernels' build directory
    and compiler reads, each waived with a reason, and nothing else."""
    rep = core.run_audit(_REPO, passes=["trace-env"], ctx=real_ctx)
    assert rep["findings"] == []
    assert sorted(d["location"] for d in rep["suppressed"]) == [
        "transmogrifai_tpu_torch/_compile_cache.py:52",
        "transmogrifai_tpu_torch/_compile_cache.py:55",
        "transmogrifai_tpu_torch/_cuda_build.py:51"]


# ---------------------------------------------------------------------------
# the port's waivers for the code the JAX package waives too
# ---------------------------------------------------------------------------

def test_the_jax_packages_waivers_hold_on_the_port(real_ctx):
    """The five stats-discipline waivers of EngineStats._book_overhead
    and the two concurrency waivers of ServingEngine's advisory
    _accepting reads, with the JAX package's reasons."""
    rep = core.run_audit(_REPO, passes=["stats-discipline",
                                        "concurrency"], ctx=real_ctx)
    assert rep["findings"] == []
    stats = [d for d in rep["suppressed"] if d["code"] == "TM-AUDIT-308"]
    assert len(stats) == 5 and all(
        d["location"].startswith("transmogrifai_tpu_torch/profiling.py:")
        and "_book_overhead" in d["message"] for d in stats)
    engine = [d for d in rep["suppressed"]
              if d["location"].startswith(
                  "transmogrifai_tpu_torch/serving/engine.py:")]
    assert len(engine) == 2 and all("_accepting" in d["message"]
                                    for d in engine)
    text = open(os.path.join(_REPO, "transmogrifai_tpu_torch",
                             "profiling.py")).read()
    assert text.count("# opaudit: disable=stats-discipline -- caller "
                      "holds _lock via _mutating()") == 5


# ---------------------------------------------------------------------------
# surface-registry over bench_gpu.py
# ---------------------------------------------------------------------------

def _bench_src(sections, order, device, summary_names):
    return MIRROR._bench_src(sections, order, device, summary_names)


def test_surface_registry_catches_each_bench_gpu_drift_axis(tmp_path):
    assert surfaces.BENCH == "bench_gpu.py"
    ctx = _ctx(tmp_path, {surfaces.BENCH: _bench_src(
        sections=["s1", "s2", "s3"], order=["s1", "s2", "s2", "ghost"],
        device=["s2", "unknown"], summary_names=["s1", "s2"])})
    msgs = [d.message for d in surfaces.run_sections(ctx)]
    assert any("'s3' in _SECTIONS but not _SECTION_ORDER" in m
               for m in msgs)
    assert any("schedules 's2' twice" in m for m in msgs)
    assert any("'ghost' is not a registered section" in m for m in msgs)
    assert any("_DEVICE_SECTIONS entry 'unknown'" in m for m in msgs)
    assert any("'s3' never appears in _summary_line" in m for m in msgs)
    assert not any("PRIORITY" in m for m in msgs)


def test_surface_registry_silent_on_a_consistent_bench_gpu(tmp_path):
    ctx = _ctx(tmp_path, {surfaces.BENCH: _bench_src(
        sections=["s1", "s2"], order=["s1", "s2"], device=["s2"],
        summary_names=["s1", "s2"])})
    assert surfaces.run_sections(ctx) == []
    # the JAX package's bench.py is not the port's registry
    ctx = _ctx(tmp_path, {"bench.py": _bench_src(
        sections=["s1"], order=[], device=[], summary_names=[])})
    assert surfaces.run_sections(ctx) == []


# ---------------------------------------------------------------------------
# the audited roots and the CLI
# ---------------------------------------------------------------------------

def test_default_roots_are_the_ports_tree_only(real_ctx):
    paths = [f.relpath for f in real_ctx.files]
    assert not any(p.startswith("transmogrifai_tpu/") for p in paths)
    assert "chip_smoke.py" in paths and "gbt_parity_probe.py" in paths
    assert "transmogrifai_tpu_torch/analysis/core.py" in paths
    tests = [p for p in paths if p.startswith("tests/")]
    assert tests and all(os.path.basename(p).startswith(("test_torch_",
                                                         "torch_"))
                         for p in tests)
    assert "bench.py" not in paths and "tpu_capture.py" not in paths


def test_cli_exit_codes_and_byte_identical_json(tmp_path, capsys):
    """0 on a clean tree, 1 with an unsuppressed finding, 2 on an
    unknown pass; two --json runs byte-identical."""
    pkg = tmp_path / "transmogrifai_tpu_torch"
    pkg.mkdir()
    (pkg / "ok.py").write_text("X = 1\n")
    assert cli.main(["--root", str(tmp_path), "--passes",
                     "knob-registry,hot-path,suppression"]) == 0
    (pkg / "bad.py").write_text(
        "import os\nY = os.environ.get('TM_FAKE_RAW')\n")
    capsys.readouterr()
    assert cli.main(["--root", str(tmp_path), "--json", "--passes",
                     "knob-registry"]) == 1
    first = capsys.readouterr().out
    assert cli.main(["--root", str(tmp_path), "--json", "--passes",
                     "knob-registry"]) == 1
    assert capsys.readouterr().out == first
    assert json.loads(first)["findings"][0]["code"] == "TM-AUDIT-302"
    with pytest.raises(SystemExit) as e:
        cli.main(["--root", str(tmp_path), "--passes", "bogus"])
    assert e.value.code == 2


def test_cli_runs_as_a_module_on_the_real_tree():
    """``python -m transmogrifai_tpu_torch.analysis`` exits 0 on the
    port's tree, in a process that never imports the analysed code
    (nor JAX)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['opaudit', '--passes', 'knob-registry,knob-docs,"
            "fault-registry,metric-registry,suppression']\n"
            "try:\n"
            "    runpy.run_module('transmogrifai_tpu_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'transmogrifai_tpu') or m.startswith("
            "'transmogrifai_tpu_torch.serving')]\n"
            "print('RC', rc, 'BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=240)
    assert "RC 0 BAD []" in out.stdout, out.stdout + out.stderr


def test_write_docs_reproduces_the_committed_port_documents(tmp_path,
                                                            real_ctx):
    """--write-docs over the real tree rebuilds the port's KNOBS.md, the
    OBSERVABILITY.md registry block and the RESILIENCE.md fault table
    exactly as committed."""
    docs = os.path.join(_REPO, "transmogrifai_tpu_torch", "docs")
    root = tmp_path / "repo"
    (root / "transmogrifai_tpu_torch" / "docs").mkdir(parents=True)
    for name in ("OBSERVABILITY.md", "RESILIENCE.md"):
        (root / "transmogrifai_tpu_torch" / "docs" / name).write_text(
            open(os.path.join(docs, name)).read())
    ctx = real_ctx
    from transmogrifai_tpu_torch.analysis import knobs
    assert knobs.render_knobs_doc(ctx) == open(
        os.path.join(docs, "KNOBS.md")).read()
    for name, begin, end, block in (
            ("OBSERVABILITY.md", surfaces._REGISTRY_BEGIN,
             surfaces._REGISTRY_END, surfaces.render_metric_registry(ctx)),
            ("RESILIENCE.md", surfaces._FAULTS_BEGIN, surfaces._FAULTS_END,
             surfaces.render_fault_registry(ctx))):
        path = str(root / "transmogrifai_tpu_torch" / "docs" / name)
        cli._splice(path, begin, end, block, "unused")
        assert open(path).read() == open(os.path.join(docs, name)).read()
    text = open(os.path.join(docs, "KNOBS.md")).read()
    for knob in ("TM_AUTOTUNE", "TM_AUTOTUNE_SERVING_MODEL", "TM_PALLAS",
                 "TM_HIST_ROWS_PER_STEP", "TM_ENGINE_REQUEST_PLANE"):
        assert f"| `{knob}` |" in text
