"""Run a JAX-package test module's cases against the port.

:func:`load_mirror` reads ``tests/<file>`` and executes its text with
every ``transmogrifai_tpu`` import pointed at ``transmogrifai_tpu_torch``,
so each case's inputs and assertions are the JAX test's own, applied to
the port's classes. A shared test helper the JAX test imports by bare
name (``serving_util``, which trains the serving suites' model) or as
``tests.serving_util`` is loaded with the same rewrite, and the import
points at that copy. :func:`mirror_cases` expands the module's test
functions (and their ``parametrize`` marks) into ``pytest.param``s, and
:func:`run_mirror_case` calls one, handing it the pytest fixtures it asks
for (``tmp_path``, ``monkeypatch``, ...).

The JAX tests name no device. The port's entry points run on the card
unless asked for the CPU, so :func:`port_on_cpu` makes ``None`` resolve
to the CPU for the duration of a mirrored case (as a caller passing
``device="cpu"`` everywhere would), socket workers included; a device
named explicitly resolves as always.
"""
from __future__ import annotations

import inspect
import os
import re
import sys
import types

import pytest

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REF = re.compile(r"\btransmogrifai_tpu\b(?!_torch)")
#: test helper modules a JAX test imports by bare name; each is loaded
#: with the same rewrite (so ``serving_util`` trains with the port) and
#: the import pointed at that copy
_HELPERS = ("serving_util",)
_HELPER_IMPORT = re.compile(
    r"^(\s*)(from|import)\s+(?:tests\.)?(" + "|".join(_HELPERS) + r")\b",
    re.M)


def _helper_import(m: "re.Match") -> str:
    load_mirror(m.group(3) + ".py")
    return f"{m.group(1)}{m.group(2)} torch_mirror_{m.group(3)}"


def load_mirror(filename: str) -> types.ModuleType:
    path = os.path.join(_TESTS, filename)
    src = _REF.sub("transmogrifai_tpu_torch", open(path).read())
    src = _HELPER_IMPORT.sub(_helper_import, src)
    mod = types.ModuleType("torch_mirror_" + filename[:-3])
    mod.__file__ = path
    # importable by name, so objects of its classes pickle
    sys.modules[mod.__name__] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def mirror_fixtures(mod: types.ModuleType) -> dict:
    """The fixtures ``mod`` defines (``served``, an autouse reset, ...),
    by name: a calling test file binds them into its own namespace
    (``globals().update(mirror_fixtures(MIRROR))``) so pytest serves
    them to the mirrored cases with their own scopes."""
    out = {}
    for name, obj in vars(mod).items():
        if type(obj).__name__ == "FixtureFunctionDefinition" or (
                isinstance(obj, types.FunctionType)
                and hasattr(obj, "_pytestfixturefunction")):
            out[name] = obj
    return out


def _param_values(v, n):
    """A parametrize entry -> (its values as a tuple, its marks)."""
    from _pytest.mark.structures import ParameterSet
    if isinstance(v, ParameterSet):
        return tuple(v.values), tuple(v.marks)
    return ((v,) if n == 1 else tuple(v)), ()


def mirror_cases(mod: types.ModuleType, skip=()) -> list:
    """One ``pytest.param(name, kwargs)`` per case of ``mod``'s test
    functions (``skip``: names left out, each with its reason in the
    calling file)."""
    out = []
    funcs = []
    for name, obj in vars(mod).items():
        if name in skip:
            continue
        if name.startswith("test_") and callable(obj):
            funcs.append((name, obj))
        elif (name.startswith("Test") and isinstance(obj, type)
              and obj.__module__ == mod.__name__
              and "__init__" not in vars(obj)):
            # a test class of the module: one case per test method
            funcs += [(f"{name}.{m}", getattr(obj, m)) for m in dir(obj)
                      if m.startswith("test_") and f"{name}.{m}" not in skip]
    for name, fn in funcs:
        marks = list(getattr(fn, "pytestmark", []))
        combos = [({}, "", ())]
        for m in [m for m in marks if m.name == "parametrize"]:
            argnames = m.args[0]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            ids = m.kwargs.get("ids")
            new = []
            for kw, cid, cm in combos:
                for i, v in enumerate(m.args[1]):
                    vals, vm = _param_values(v, len(argnames))
                    label = (ids[i] if isinstance(ids, (list, tuple))
                             else str(i))
                    new.append(({**kw, **dict(zip(argnames, vals))},
                                f"{cid}[{label}]", cm + tuple(vm)))
            combos = new
        other = tuple(m for m in marks if m.name != "parametrize")
        for kw, cid, cm in combos:
            out.append(pytest.param(name, kw, id=name + cid,
                                    marks=other + cm))
    return out


def run_mirror_case(mod: types.ModuleType, name: str, kwargs: dict,
                    request) -> None:
    if "." in name:
        cls, meth = name.split(".")
        fn = getattr(getattr(mod, cls)(), meth)
    else:
        fn = getattr(mod, name)
    args = {}
    for p in inspect.signature(fn).parameters:
        args[p] = kwargs[p] if p in kwargs else request.getfixturevalue(p)
    fn(**args)


def cpu_default(monkeypatch) -> None:
    """Through ``monkeypatch``: ``resolve_device(None)`` -> the CPU in
    every loaded port module, and a socket worker built with no device
    is handed the CPU."""
    from transmogrifai_tpu_torch import _device
    orig = _device.resolve_device

    def resolve_cpu(device=None):
        return orig("cpu" if device is None else device)

    monkeypatch.setattr(_device, "resolve_device", resolve_cpu)
    for m in list(sys.modules.values()):
        if getattr(m, "__name__", "").startswith("transmogrifai_tpu_torch") \
                and getattr(m, "resolve_device", None) is orig:
            monkeypatch.setattr(m, "resolve_device", resolve_cpu)
    # a worker process resolves its own device: a transport built with
    # none names the CPU for it, as such a caller would
    from transmogrifai_tpu_torch.serving.transport import tcp
    init = tcp.ProcessWorkerTransport.__init__

    def cpu_worker(self, *args, device=None, **kw):
        init(self, *args, device="cpu" if device is None else device, **kw)

    monkeypatch.setattr(tcp.ProcessWorkerTransport, "__init__", cpu_worker)


@pytest.fixture
def port_on_cpu(monkeypatch):
    """:func:`cpu_default` while the case runs."""
    cpu_default(monkeypatch)
    yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in a mirror file that imports it: one torch thread while
    the mirrored module runs. The suite runs several workers at once,
    and torch's intra-op threads on these small tensors only contend
    (the JAX cases' watchdog budgets assume a process that is not
    oversubscribed)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
