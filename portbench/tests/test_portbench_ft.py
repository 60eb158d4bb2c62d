"""The ``higgs.ft`` cell's own faults, planted under its timed path (the
rehearsal, ``test_portbench_rehearsal.py``, judges each not correct), the
entry's refusal of a program without the published FT-Transformer, and
the benchmark's copy of the plain reference against the CPU tests'."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import run
from portbench.reference import ft_transformer as ref


def _half_batch(monkeypatch):
    """Each step's loss over the first half of its batch's rows: the rest
    zero-weighted, the mean taken over the half."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    real = FT._train_loss_grad

    def half(flat, layout, Xs, y, w, at, *a, **k):
        keep = (torch.arange(at.ok.shape[1], device=at.ok.device)
                < at.ok.shape[1] // 2).to(at.ok.dtype)
        return real(flat, layout, Xs, y, w, at._replace(ok=at.ok * keep),
                    *a, **k)
    monkeypatch.setattr(FT, "_train_loss_grad", half)


def _half_batch_gradient(monkeypatch):
    """Each step's gradient taken over the first half of its batch's loss
    terms alone, the others detached; the loss terms as they were."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    real = FT._pub_loss

    def half(z, y, w, n_classes):
        terms = real(z, y, w, n_classes)
        h = terms.shape[1] // 2
        return torch.cat([terms[:, :h], terms[:, h:].detach()], dim=1)
    monkeypatch.setattr(FT, "_pub_loss", half)


def _zeroed_leaf_gradient(monkeypatch):
    """The head bias's gradient zeroed at every step, the other leaves'
    as they were (its parameter and Adam state then follow the zero)."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    real = FT._train_loss_grad

    def zeroed(flat, layout, *a, **k):
        loss, g = real(flat, layout, *a, **k)
        i = layout.paths.index(("head_b",))
        off = sum(layout.spans[:i])
        g[:, off:off + layout.sizes[i]] = 0
        return loss, g
    monkeypatch.setattr(FT, "_train_loss_grad", zeroed)


def _no_dropout(monkeypatch):
    """The steps draw no dropout mask."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    monkeypatch.setattr(FT, "_step_keeps",
                        lambda rec, *a, **k: [{}] * rec.n_blocks)


def _first_block_attention_norm(monkeypatch):
    """Block 0 normalises its attention's input (rtdl's
    ``first_prenormalization=True``)."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    real = FT._pub_forward

    def normed(net, wc, Xs, keeps, cdt):
        b0 = net["blocks"][0]
        G, D = b0["ffn_ln"]["g"].shape
        ln = {"g": torch.ones(G, D, device=Xs.device),
              "b": torch.zeros(G, D, device=Xs.device)}
        net = dict(net, blocks=[dict(b0, attn_ln=ln)] + net["blocks"][1:])
        return real(net, wc, Xs, keeps, cdt)
    monkeypatch.setattr(FT, "_pub_forward", normed)


def _gelu_for_reglu(monkeypatch):
    """The feed-forward gated by GELU where ReGLU gates it by ReLU."""
    from transmogrifai_tpu_torch.models import ft_published as FT

    def geglu(u):
        a, g = u.chunk(2, dim=-1)
        return a * F.gelu(g)
    monkeypatch.setattr(FT, "_reglu", geglu)


def _unchanged_adam_state(monkeypatch):
    """Every step updates the parameters but leaves Adam's moments as
    they were."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    real = FT._adamw_step

    def same(flat, g, m, v, *a, **k):
        m0, v0 = m.clone(), v.clone()
        real(flat, g, m, v, *a, **k)
        m.copy_(m0)
        v.copy_(v0)
    monkeypatch.setattr(FT, "_adamw_step", same)


def _another_folds_rows(monkeypatch):
    """Each fold's items fit and score on the next fold's rows."""
    from transmogrifai_tpu_torch.models import tuning
    real = tuning.fold_slice_batch

    def rolled(train_m, val_m, g):
        return real(np.roll(train_m, 1, axis=0), np.roll(val_m, 1, axis=0),
                    g)
    monkeypatch.setattr(tuning, "fold_slice_batch", rolled)


def _worst_item_picked(monkeypatch):
    """The validator names the grid point of the worst mean metric."""
    from transmogrifai_tpu_torch.models import tuning
    real = tuning.OpValidator.collect

    def worst(self, pending):
        r = real(self, pending)
        r.best_index = int(np.argmin(r.grid_metrics) if r.larger_is_better
                           else np.argmax(r.grid_metrics))
        return r
    monkeypatch.setattr(tuning.OpValidator, "collect", worst)


def _altered_logits(monkeypatch):
    """The published model's logits altered where they are made: every
    fifth row's negated."""
    from transmogrifai_tpu_torch.models import ft_published as FT
    real = FT.FTTransformerPublishedClassifierFamily.logits

    def altered(self, params, X):
        z = real(self, params, X)
        flip = (torch.arange(z.shape[0], device=z.device) % 5 == 0)[:, None]
        return torch.where(flip, -z, z)
    monkeypatch.setattr(FT.FTTransformerPublishedClassifierFamily, "logits",
                        altered)


@pytest.mark.parametrize("name", ["_half_batch_gradient",
                                  "_zeroed_leaf_gradient"])
def test_a_gradient_only_fault_fails_on_the_gradient_alone(name,
                                                           monkeypatch):
    """A fault in the backward pass alone leaves the loss terms, the
    update from the program's own gradient and the fitted models' scores
    in their limits: only ``step_grad_gap`` reads it."""
    globals()[name](monkeypatch)
    with open(os.path.join(run.BENCH, "tests", "rehearsal",
                           "higgs.ft.json")) as f:
        rows = json.load(f)["rows"]
    _, table = run.run_cell(run.load_cell("higgs.ft"), 2 ** 31 + 9, 0.0,
                            False, device="cpu", rows=rows, warmup=False)
    assert [k for k, r in table.items() if not r["ok"]] == ["step_grad_gap"]


# ---------------------------------------------------------------------------
# the entry's refusal, and the two copies of the reference
# ---------------------------------------------------------------------------

def test_the_entry_refuses_a_program_without_the_published_recipe(
        monkeypatch):
    """A program without the published family (the toy FT family alone)
    is refused before any rows are made."""
    from portbench import generators
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    monkeypatch.delitem(MODEL_FAMILIES, "FTTransformerPublishedClassifier")
    made = []
    real = generators.GENERATORS["training_data"]
    monkeypatch.setitem(generators.GENERATORS, "training_data",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    cell = run.load_cell("higgs.ft")
    with pytest.raises(SystemExit, match="lacks the published"):
        cell["entry"](cell["config"], cell["mix"], 3, "cpu", rows=100)
    assert made == []


def test_the_entry_refuses_a_family_that_is_not_the_configuration(
        monkeypatch):
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    monkeypatch.setattr(MODEL_FAMILIES["FTTransformerPublishedClassifier"],
                        "n_heads", 4)
    cell = run.load_cell("higgs.ft")
    with pytest.raises(SystemExit, match="n_heads 4"):
        cell["entry"](cell["config"], cell["mix"], 3, "cpu", rows=100)


def _tests_reference():
    path = os.path.join(run.ROOT, "tests", "ft_reference.py")
    spec = importlib.util.spec_from_file_location("ft_reference_cpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_benchmarks_reference_gives_the_cpu_tests_numbers():
    other = _tests_reference()
    cfg = {"d_token": 16, "n_blocks": 3, "n_heads": 4, "ffn_hidden": 21,
           "attention_dropout": 0.2, "ffn_dropout": 0.1}
    g = torch.Generator().manual_seed(0)
    D, H, Fh, d = 16, 4, 21, 5

    def r(*shape):
        return 0.3 * torch.randn(*shape, generator=g)

    def ln():
        return {"g": 1 + r(D), "b": r(D)}
    net = {"tok_w": r(d, D), "tok_b": r(d, D), "cls": r(D), "blocks": [],
           "head_ln": ln(), "head_w": r(D, 1), "head_b": r(1)}
    for i in range(3):
        blk = {} if i == 0 else {"attn_ln": ln()}
        blk.update(wqkv=r(D, 3, H, D // H), bqkv=r(3 * D), wo=r(D, D),
                   bo=r(D), ffn_ln=ln(), w1=r(D, 2 * Fh), b1=r(2 * Fh),
                   w2=r(Fh, D), b2=r(D))
        net["blocks"].append(blk)
    X = torch.randn(40, d, generator=g)
    y = (X[:, 0] > 0).to(torch.float32)
    w = torch.ones(40)
    for mod in (ref, other):
        np.testing.assert_array_equal(mod.epoch_order(42, 1, 0, 100),
                                      ref.epoch_order(42, 1, 0, 100))
        assert mod.mask_seed(42, 0, 3, 2, 1) == ref.mask_seed(42, 0, 3, 2, 1)
    ma = ref.dropout_masks(cfg, 42, 0, 3, 40, d + 1, "cpu")
    mb = other.dropout_masks(cfg, 42, 0, 3, 40, d + 1, "cpu")
    for a, b in zip(ma, mb):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])
    la, ga = ref.loss_and_grad(net, X, y, w, 2, ma)
    lb, gb = other.loss_and_grad(net, X, y, w, 2, mb)
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    decay = torch.cat([torch.full((t.numel(),), float(ref.decays(p)))
                       for p, t in ref.leaves(net)])
    p = torch.cat([t.reshape(-1) for _, t in ref.leaves(net)])
    gf = torch.cat([t.reshape(-1) for t in ga])
    for a, b in zip(ref.adamw(p, gf, gf, gf * gf, 3, 1e-3, 0.1, decay),
                    other.adamw(p, gf, gf, gf * gf, 3, 1e-3, 0.1, decay)):
        assert torch.equal(a, b)
    assert torch.equal(ref.logits_blocked(net, X[0], X[1] + 2, X, rows=7),
                       other.logits_blocked(net, X[0], X[1] + 2, X, rows=7))
