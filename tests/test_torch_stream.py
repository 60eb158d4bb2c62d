"""The port's ``io/stream.py`` against the JAX package's on the CPU:
``host_prefetch`` and ``double_buffer`` (order, positional exceptions,
cancellation), ``prefetch_to_device``, ``csv_chunks`` and
``csv_chunks_native`` (the same column dicts), ``fit_streaming``'s
checkpoints crossing packages both ways, and ``FusedScorer.score_stream``
against ``score_arrays``. Mirrors ``tests/test_serving_stream.py`` and
the stream cases of ``tests/test_sparse.py`` and
``tests/test_hardening.py``.

Tolerances: host code and integer columns compare exactly; a streamed
fit resumed from a checkpoint written by the other package agrees with
the resuming package's uninterrupted fit within rtol 1e-5 (the two
packages' update sequences differ only in summation order, as in
``tests/test_torch_sparse.py``), and with its own package's resume
bitwise; a streamed chunk's scores equal its batch scores bitwise
(the same row-independent tail).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import transmogrifai_tpu.io.stream as JIO
import transmogrifai_tpu.models.sparse as JS
import transmogrifai_tpu_torch.io.stream as TIO
import transmogrifai_tpu_torch.models.sparse as TS

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_prefetch_order_errors_and_release():
    def gen():
        for i in range(8):
            yield i
    assert list(TIO.host_prefetch(gen(), buffer_size=2)) == list(range(8))

    def boom():
        yield 1
        yield 2
        raise KeyError("source broke")
    got = []
    with pytest.raises(KeyError, match="source broke"):
        for v in TIO.host_prefetch(boom(), buffer_size=2):
            got.append(v)
    assert got == [1, 2]
    with pytest.raises(ValueError):
        list(TIO.host_prefetch(iter(()), buffer_size=0))
    # an abandoned consumer releases the producer thread
    pulled = []

    def tracked():
        for i in range(1000):
            pulled.append(i)
            yield i
    it = TIO.host_prefetch(tracked(), buffer_size=4)
    assert next(it) == 0
    it.close()
    time.sleep(0.3)
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n < 1000


def test_host_prefetch_cancellation():
    ev = threading.Event()

    def slow():
        i = 0
        while True:
            yield i
            i += 1
            time.sleep(0.01)
    it = TIO.host_prefetch(slow(), buffer_size=2, cancel_event=ev)
    assert next(it) == 0
    ev.set()
    with pytest.raises(TIO.StreamCancelled):
        for _ in range(1000):
            next(it)


def test_double_buffer_primitive_matches_jax():
    for mod in (TIO, JIO):
        calls = []
        out = list(mod.double_buffer(range(5),
                                     lambda x: calls.append(x) or x * 2,
                                     lambda x: x + 1, depth=2))
        assert out == [1, 3, 5, 7, 9] and calls == [0, 1, 2, 3, 4]

        def bad():
            yield 1
            yield 2
            raise KeyError("boom")
        got = []
        with pytest.raises(KeyError):
            for v in mod.double_buffer(bad(), lambda x: x, lambda x: x,
                                       depth=3):
                got.append(v)
        assert got == [1, 2]
        with pytest.raises(ValueError):
            list(mod.double_buffer(range(3), lambda x: x, lambda x: x,
                                   depth=0))


def test_prefetch_to_device_order_values_and_dtypes():
    chunks = [{"a": np.full((4,), i, np.float64),
               "b": (np.arange(3, dtype=np.int64) + i,
                     torch.full((2,), float(i)))} for i in range(7)]
    out = list(TIO.prefetch_to_device(iter(chunks), buffer_size=3,
                                      device=CPU, host_thread=True))
    assert len(out) == 7
    for i, c in enumerate(out):
        assert c["a"].dtype == torch.float32
        assert c["b"][0].dtype == torch.int32
        np.testing.assert_array_equal(c["a"].numpy(), chunks[i]["a"])
        np.testing.assert_array_equal(c["b"][0].numpy(), chunks[i]["b"][0])
        assert torch.equal(c["b"][1], chunks[i]["b"][1])
    # the copy owns its memory: overwriting the source changes nothing
    src = {"a": np.ones(5, np.float32)}
    got = next(TIO.prefetch_to_device(iter([src]), device=CPU))
    src["a"][:] = 7
    assert torch.equal(got["a"], torch.ones(5))
    with pytest.raises(ValueError):
        list(TIO.prefetch_to_device(iter(()), buffer_size=0, device=CPU))


def test_tree_flatten_order_matches_jax():
    import jax
    state = ({"table": np.zeros(3), "dense": np.ones(2), "bias": 0.0,
              "emb": np.zeros((3, 2))},
             {"z": {"b": 1, "a": 2}, "n": [3, (4, 5)]})
    leaves, struct = TIO.tree_flatten(state)
    assert [np.asarray(x).tolist() for x in leaves] == \
        [np.asarray(x).tolist() for x in jax.tree.leaves(state)]
    back = TIO.tree_unflatten(struct, leaves)
    assert list(back[0]) == sorted(state[0])
    assert back[1]["n"][1] == (4, 5)


def _schema_csv(tmp_path, pkg):
    import importlib
    ft = importlib.import_module(pkg + ".features.types")
    path = tmp_path / "s.csv"
    rows = ["x,c,k"] + [f"{i * 0.5},{'NA' if i % 5 == 0 else f'v{i % 3}'},"
                        f"{'' if i % 7 == 0 else i}" for i in range(250)]
    path.write_text("\n".join(rows) + "\n")
    return str(path), {"x": ft.Real, "c": ft.PickList, "k": ft.Integral}


@pytest.mark.parametrize("native", [True, False])
def test_csv_chunks_equal_jax(tmp_path, native):
    """The same chunks, column for column (NaN nulls compared as NaN,
    object columns as values), through the DictReader path and the
    native block parser (64-byte blocks: many record cuts)."""
    path, tschema = _schema_csv(tmp_path, "transmogrifai_tpu_torch")
    _, jschema = _schema_csv(tmp_path, "transmogrifai_tpu")
    if native:
        got = list(TIO.csv_chunks_native(path, tschema, chunk_bytes=64))
        want = list(JIO.csv_chunks_native(path, jschema, chunk_bytes=64))
    else:
        got = list(TIO.csv_chunks(path, tschema, chunk_rows=40))
        want = list(JIO.csv_chunks(path, jschema, chunk_rows=40))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k].dtype == object:
                assert g[k].tolist() == w[k].tolist()
            else:
                np.testing.assert_array_equal(g[k], w[k])


def _stream_data(seed=0, n=2048, K=4, d=3, B=256):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, B, (n, K)).astype(np.int32)
    num = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = np.ones(n, np.float32)

    def chunks():
        for s in range(0, n, 256):
            yield {"idx": idx[s:s + 256], "num": num[s:s + 256],
                   "y": y[s:s + 256], "w": w[s:s + 256]}
    return chunks, B, d


def _killing(mod, after):
    """Wrap ``mod.fit_streaming`` so the step after ``after`` steps
    raises (a killed fit), checkpointing every 2 chunks."""
    orig = mod.fit_streaming

    def wrapped(step_fn, state, chunks, **kw):
        n = {"steps": 0}

        def dying(s, c):
            n["steps"] += 1
            if n["steps"] > after:
                raise KeyboardInterrupt("killed")
            return step_fn(s, c)
        return orig(dying, state, chunks, **dict(kw, checkpoint_every=2))
    return orig, wrapped


@pytest.mark.parametrize("family", ["adagrad", "ftrl", "fm"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stream_checkpoint_crosses_packages(tmp_path, family, writer):
    """A streamed fit killed mid-stream by one package (its npz of the
    state's leaves in jax.tree.flatten order, progress and token) is
    resumed by the other: the result equals the resuming package's
    uninterrupted fit within rtol 1e-5; the checkpoint is deleted."""
    chunks, B, d = _stream_data()
    ck = str(tmp_path / "ck")
    emb = np.asarray(JS.init_sparse_fm(B, d, 4, 1)["emb"])

    def run(pkg, ckpt=None):
        if pkg == "port":
            kw = dict(device=CPU, checkpoint_dir=ckpt)
            if family == "adagrad":
                return TS.fit_sparse_lr_streaming(chunks, B, d, lr=0.1,
                                                  l2=1e-4, epochs=2,
                                                  batch_size=128, **kw)
            if family == "ftrl":
                return TS.fit_sparse_ftrl_streaming(chunks, B, d, alpha=0.2,
                                                    epochs=2, batch_size=128,
                                                    **kw)
            return TS.fit_sparse_fm_streaming(chunks, B, d, k=4, lr=0.1,
                                              epochs=2, batch_size=128,
                                              seed=1, emb=emb, **kw)
        kw = dict(checkpoint_dir=ckpt)
        if family == "adagrad":
            return JS.fit_sparse_lr_streaming(chunks, B, d, lr=0.1, l2=1e-4,
                                              epochs=2, batch_size=128, **kw)
        if family == "ftrl":
            return JS.fit_sparse_ftrl_streaming(chunks, B, d, alpha=0.2,
                                                epochs=2, batch_size=128,
                                                **kw)
        return JS.fit_sparse_fm_streaming(chunks, B, d, k=4, lr=0.1,
                                          epochs=2, batch_size=128, seed=1,
                                          **kw)

    mod = TIO if writer == "port" else JIO
    orig, wrapped = _killing(mod, after=11)
    mod.fit_streaming = wrapped
    try:
        with pytest.raises(KeyboardInterrupt):
            run(writer, ck)
    finally:
        mod.fit_streaming = orig
    path = os.path.join(ck, "stream_fit.ckpt.npz")
    assert os.path.exists(path)
    reader = "jax" if writer == "port" else "port"
    resumed = run(reader, ck)
    assert not os.path.exists(path)
    want = run(reader)
    for k in want:
        np.testing.assert_allclose(np.asarray(resumed[k]),
                                   np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_stream_checkpoint_resume_is_bitwise_and_rejects_drift(tmp_path):
    chunks, B, d = _stream_data(seed=1)
    ck = str(tmp_path / "ck")
    kw = dict(lr=0.1, epochs=2, batch_size=128, device=CPU)
    want = TS.fit_sparse_lr_streaming(chunks, B, d, **kw)
    orig, wrapped = _killing(TIO, after=9)
    TIO.fit_streaming = wrapped
    try:
        with pytest.raises(KeyboardInterrupt):
            TS.fit_sparse_lr_streaming(chunks, B, d, checkpoint_dir=ck, **kw)
    finally:
        TIO.fit_streaming = orig
    with pytest.raises(ValueError, match="different configuration"):
        TS.fit_sparse_lr_streaming(chunks, B, d, checkpoint_dir=ck,
                                   **dict(kw, lr=0.2))
    with pytest.raises(ValueError, match="state structure"):
        TS.fit_sparse_lr_streaming(chunks, B * 2, d, checkpoint_dir=ck,
                                   **kw)
    got = TS.fit_sparse_lr_streaming(chunks, B, d, checkpoint_dir=ck, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="reiterable"):
        TIO.fit_streaming(lambda s, c: s, {}, iter(()), epochs=2,
                          device=CPU)


def _ctr_scorer():
    """A port-fitted sparse front-door model and its records."""
    from tests.test_torch_sparse import _front_records, _front_workflow
    recs = _front_records(900, seed=2)
    wf, m = _front_workflow("transmogrifai_tpu_torch")
    model = wf.train(m(".readers").DataReaders.simple(recs), device=CPU)
    return model, recs


def test_score_stream_equals_score_and_reraises_positionally():
    """Each streamed chunk's scores equal score_arrays of that chunk
    bitwise (threaded and inline host prefix, bucketed); a producer
    error surfaces after the chunks before it; a set cancel_event
    raises StreamCancelled."""
    model, recs = _ctr_scorer()
    name = model.result_features[0].name
    for buckets in (None, (64, 256)):
        sc = model.compile_scoring(buckets=buckets, device=CPU)
        whole = sc.score_arrays(recs)[name]
        for host_thread in (True, False):
            parts = [recs[s:s + 200] for s in range(0, 900, 200)]
            outs = list(sc.score_stream(iter(parts), buffer_size=2,
                                        host_thread=host_thread))
            assert len(outs) == len(parts)
            np.testing.assert_array_equal(
                np.concatenate([o[name] for o in outs]), whole)

            def bad():
                yield recs[:100]
                yield recs[100:300]
                raise RuntimeError("source went away")
            got = []
            with pytest.raises(RuntimeError, match="source went away"):
                for o in sc.score_stream(bad(), host_thread=host_thread):
                    got.append(o)
            assert len(got) == 2
            np.testing.assert_array_equal(got[1][name], whole[100:300])
    ev = threading.Event()
    ev.set()
    with pytest.raises(TIO.StreamCancelled):
        list(model.compile_scoring(device=CPU).score_stream(
            iter([recs[:10]]), cancel_event=ev))
    # the score_stream over the workflow's Prediction column agrees
    ds = model.score(recs)
    p1 = np.asarray([r["probability_1"] for r in ds.column(name)])
    np.testing.assert_array_equal(p1, whole[:, 1].astype(np.float64))
