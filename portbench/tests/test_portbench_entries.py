"""A new configuration's entry joins the harness as a file of its own,
``portbench/entry_<name>.py``, found by ``entries.resolve``: planted here
as a module, it runs through ``run.run_cell`` and ``control.readings``
though nothing in the harness names it, and a mix whose entry cannot be
found fails when its cell is loaded."""
import contextlib
import importlib
import sys
import types

import pytest
import torch

from portbench import check, run
from portbench.control import readings
from portbench.entries import SelectorEntry, SparseSelectorEntry, resolve
from portbench.reference import metrics
from portbench.reference.precision import OPERAND

ROWS = 6000
BASE = "higgs.linear"
GAP = "planted_logloss_gap"


class PlantedEntry(SelectorEntry):
    """The linear selector with a judge of its own: the holdout log loss
    the program reports against the reference's (float64) log loss of
    the winner's own scores of the holdout rows; its control rounds those
    scores to bf16 before the log loss."""

    def sweep_fits(self, out):
        # the families of this mix have no fold fits to read
        return contextlib.nullcontext(out)

    def _scores(self, fit, device):
        rows = check.Rows(self.X, self.y, self.folds, device)
        best = fit["summary"]["bestModel"]
        params = {k: torch.as_tensor(v).to(rows.X.device)
                  for k, v in fit["params"].items()}
        return check.score(best["family"], best["hyper"], params,
                           rows.Xh), rows.yh

    def judge(self, fit, device):
        s, yh = self._scores(fit, device)
        ll = metrics.logloss(s, yh)
        got = float(fit["summary"]["holdoutEvaluation"]["LogLoss"])
        return {GAP: abs(got - ll) / ll}

    def control(self, fit, device):
        s, yh = self._scores(fit, device)
        ev = {"LogLoss": metrics.logloss(OPERAND["bf16"](s), yh)}
        return dict(fit, summary=dict(fit["summary"], holdoutEvaluation=ev))


class OverLimitEntry(PlantedEntry):
    """A judge whose number lies over the cell's limit."""

    def judge(self, fit, device):
        return {GAP: 1.0}


def _plant(monkeypatch, name, cls):
    mod = types.ModuleType("portbench.entry_" + name)
    mod.ENTRY = cls
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def _mix_entry(monkeypatch, entry, **more):
    """The base cell's mix, as ``run.load_cell`` reads it, naming the
    entry ``entry``."""
    real = run._load
    monkeypatch.setattr(run, "_load", lambda kind, name: (
        dict(real(kind, name), entry=entry, **more) if kind == "mixes"
        else real(kind, name)))


def _cell(monkeypatch, name):
    """The base cell, loaded with its mix driving entry ``name`` and a
    limit for the planted judge's one number."""
    _mix_entry(monkeypatch, name, candidates=["LogisticRegression"])
    cell = run.load_cell(BASE)
    cell["limits"] = {GAP: 1e-5}
    return cell


@pytest.mark.parametrize("name,cls,correct",
                         [("planted", PlantedEntry, True),
                          ("over_limit", OverLimitEntry, False)])
def test_a_planted_entry_runs_through_run_cell(monkeypatch, name, cls,
                                               correct):
    _plant(monkeypatch, name, cls)
    cell = _cell(monkeypatch, name)
    assert cell["entry"] is cls
    result, table = run.run_cell(cell, 2 ** 31 + 21, 0.0, False,
                                 device="cpu", rows=ROWS, warmup=False)
    assert result["correct"] is correct, table
    assert set(table) == {GAP}
    assert list(result["checks"]) == [GAP]
    assert result["attempted"] == 1
    assert result["metrics"]["fit_s"]["value"] > 0


def test_a_planted_entry_runs_through_control_readings(monkeypatch):
    _plant(monkeypatch, "planted", PlantedEntry)
    cell = _cell(monkeypatch, "planted")
    monkeypatch.setattr(run, "load_cell", lambda name: cell)
    recs = readings("planted.cell", [2 ** 31 + 22], [2 ** 31 + 22],
                    device="cpu", rows=ROWS, emit=lambda s: None)
    assert [r["side"] for r in recs] == ["program", "control"]
    prog, ctl = (check.verdict(r["numbers"], cell["limits"]) for r in recs)
    assert check.all_ok(prog), prog
    assert not check.all_ok(ctl), ctl


#: a module name in ``run.FORBIDDEN`` for the tests below alone
STANDIN = "portbench_stand_in_for_jax"


class LoadsForbidden(PlantedEntry):
    """A judge that loads a forbidden module as it runs."""

    def judge(self, fit, device):
        sys.modules[STANDIN] = types.ModuleType(STANDIN)
        return super().judge(fit, device)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(run, "FORBIDDEN", run.FORBIDDEN + (STANDIN,))
    yield
    sys.modules.pop(STANDIN, None)


def test_a_judge_that_loads_jax_gives_no_result(monkeypatch, stand_in):
    _plant(monkeypatch, "loads", LoadsForbidden)
    with pytest.raises(run.Forbidden, match=STANDIN):
        run.run_cell(_cell(monkeypatch, "loads"), 2 ** 31 + 23, 0.0, False,
                     device="cpu", rows=ROWS, warmup=False)


def test_control_readings_that_load_jax_give_no_readings(monkeypatch,
                                                         stand_in):
    _plant(monkeypatch, "loads", LoadsForbidden)
    cell = _cell(monkeypatch, "loads")
    monkeypatch.setattr(run, "load_cell", lambda name: cell)
    with pytest.raises(run.Forbidden, match=STANDIN):
        readings("loads.cell", [2 ** 31 + 24], [], device="cpu", rows=ROWS,
                 emit=lambda s: None)


#: the accepted cells and the entry classes they drive
ACCEPTED = {"higgs.trees": SelectorEntry, "higgs.linear": SelectorEntry,
            "higgs.default": SelectorEntry,
            "criteo.sweep": SparseSelectorEntry}


@pytest.mark.parametrize("cell", sorted(ACCEPTED))
def test_the_four_cells_resolve_to_their_classes(cell):
    c = run.load_cell(cell)
    assert c["entry"] is resolve(c["mix"]["entry"]) is ACCEPTED[cell]


@pytest.mark.parametrize("entry,says", [
    ("no_such_entry", "portbench/entry_no_such_entry.py"),
    ("no_class", "portbench/entry_no_class.py"),
    ("Upper", "does not match"),
    ("a.b", "does not match"),
    ("../x", "does not match"),
    ("a" * 33, "does not match"),
    (None, "does not match"),
])
def test_a_cell_whose_entry_cannot_be_found_fails_to_load(monkeypatch,
                                                          entry, says):
    # a module without ENTRY
    monkeypatch.setitem(sys.modules, "portbench.entry_no_class",
                        types.ModuleType("portbench.entry_no_class"))
    _mix_entry(monkeypatch, entry)
    with pytest.raises(SystemExit) as e:
        run.load_cell(BASE)
    assert says in str(e.value)


@pytest.fixture
def entry_dir(tmp_path, monkeypatch):
    """A directory searched for ``portbench.entry_*`` modules, as the
    package's own is."""
    import portbench
    before = set(sys.modules)
    monkeypatch.setattr(portbench, "__path__",
                        list(portbench.__path__) + [str(tmp_path)])
    importlib.invalidate_caches()
    yield tmp_path
    for name in set(sys.modules) - before:
        del sys.modules[name]


def test_an_entry_file_is_found_by_its_name(entry_dir):
    (entry_dir / "entry_from_file.py").write_text(
        "from portbench.entries import SelectorEntry\n\n\n"
        "class FileEntry(SelectorEntry):\n    pass\n\n\n"
        "ENTRY = FileEntry\n")
    cls = resolve("from_file")
    assert cls.__name__ == "FileEntry" and issubclass(cls, SelectorEntry)


def test_an_entry_file_that_fails_to_import_is_not_called_missing(
        entry_dir):
    (entry_dir / "entry_broken.py").write_text(
        "import portbench_no_such_module  # noqa: F401\n")
    with pytest.raises(ModuleNotFoundError) as e:
        resolve("broken")
    assert e.value.name == "portbench_no_such_module"
