"""The port's wire protocol, transports and socket workers: frames
byte-identical to the JAX package's for the same inputs (each package
decodes the other's), a worker asked for CUDA on a machine without it
failing before it binds, and the JAX package's ``tests/test_transport.py``
case for case on the port."""
import os

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,
                          port_on_cpu, run_mirror_case)  # noqa: F401

PKGS = ("transmogrifai_tpu", "transmogrifai_tpu_torch")


def _wire(pkg):
    import importlib
    return importlib.import_module(f"{pkg}.serving.transport.wire")


def _columns(seed=0, n=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[1] = np.nan
    x[2] = np.inf
    return {"x0": x, "x1": rng.normal(size=n).astype(np.float32),
            "ids": rng.integers(0, 1 << 40, size=n)}


def _dataset(pkg, cols):
    import importlib
    root = importlib.import_module(pkg)
    ft = root.features.types
    return root.Dataset({"x0": cols["x0"], "label": np.zeros(len(cols["x0"]))},
                        {"x0": ft.Real, "label": ft.RealNN})


class _UnknownRemote(RuntimeError):
    """An error type neither package's taxonomy knows."""
    retryable = True


def _frames(pkg):
    """One frame of every kind, from the same inputs."""
    w = _wire(pkg)
    adm = __import__(f"{pkg}.serving.admission", fromlist=["x"])
    cols = _columns()
    scores = {"pred": np.stack([1 - cols["x1"], cols["x1"]], axis=1),
              "aux": cols["x0"][:, None]}
    return {
        "submit_columns": w.encode_frame(w.T_SUBMIT, 7, w.encode_submit(
            cols, deadline_ms=250.0, trace="t-1", priority="low",
            model="m007", tenant="acme")),
        "submit_dataset": w.encode_frame(w.T_SUBMIT, 8, w.encode_submit(
            _dataset(pkg, cols))),
        "result": w.encode_frame(w.T_RESULT, 7, w.encode_result(
            scores, engine_s=0.00125)),
        "error": w.encode_frame(w.T_ERROR, 9, w.encode_error(
            adm.DeadlineExpired("late by 3 ms"))),
        "error_unknown": w.encode_frame(w.T_ERROR, 10, w.encode_error(
            _UnknownRemote("boom"))),
        "control": w.encode_frame(w.T_CONTROL, 11, w.encode_control(
            "wait_ms", last_n=64, q=0.99)),
        "reply": w.encode_frame(w.T_REPLY, 11, w.encode_reply(
            {"ok": True, "value": [3, 1]})),
        "ping": w.encode_frame(w.T_PING, 0),
    }


def test_wire_frames_are_byte_identical_across_packages():
    jax_frames, port_frames = (_frames(p) for p in PKGS)
    assert list(jax_frames) == list(port_frames)
    for kind in jax_frames:
        assert port_frames[kind] == jax_frames[kind], kind
    w = _wire("transmogrifai_tpu_torch")
    assert w.WIRE_VERSION == _wire("transmogrifai_tpu").WIRE_VERSION
    assert w.HEADER.format == _wire("transmogrifai_tpu").HEADER.format


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)],
                         ids=["jax_to_port", "port_to_jax"])
def test_wire_each_package_decodes_the_others_frames(writer, reader):
    frames = _frames(PKGS[writer])
    r = _wire(PKGS[reader])

    def body(frame):
        ftype, corr, payload = r.split_header(frame)
        return ftype, corr, payload

    ftype, corr, payload = body(frames["submit_columns"])
    assert (ftype, corr) == (r.T_SUBMIT, 7)
    data, env = r.decode_submit(payload)
    want = _columns()
    assert sorted(data) == sorted(want)
    for k in want:
        assert data[k].dtype == want[k].dtype
        assert data[k].tobytes() == want[k].tobytes()     # NaN/inf bits
    assert env == {"deadline_ms": 250.0, "trace": "t-1",
                   "priority": "low", "model": "m007", "tenant": "acme"}
    data, _ = r.decode_submit(body(frames["submit_dataset"])[2])
    assert type(data).__module__.split(".")[0] == PKGS[reader]
    assert data.ftype("label").__name__ == "RealNN"
    assert data.column("x0").tobytes() == want["x0"].tobytes()
    scores, engine_s = r.decode_result(body(frames["result"])[2])
    assert engine_s == 0.00125 and sorted(scores) == ["aux", "pred"]
    err = r.decode_error(body(frames["error"])[2])
    assert type(err).__name__ == "DeadlineExpired"
    assert type(err).__module__.startswith(PKGS[reader])
    unknown = r.decode_error(body(frames["error_unknown"])[2])
    assert isinstance(unknown, r.RemoteError) and unknown.retryable
    assert r.decode_control(body(frames["control"])[2]) == (
        "wait_ms", {"last_n": 64, "q": 0.99})
    assert r.decode_reply(body(frames["reply"])[2]) == {
        "ok": True, "value": [3, 1]}
    assert body(frames["ping"])[:2] == (r.T_PING, 0)


def test_worker_without_cuda_fails_before_binding(tmp_path):
    """A socket worker given no device resolves CUDA; on a machine
    without it the process exits before it binds, the supervisor
    raises WorkerUnavailable carrying the worker's CUDA error from its
    log tail, and nothing restarts it on the CPU."""
    from transmogrifai_tpu_torch.serving.transport import (
        ProcessWorkerTransport, TransportConfig, WorkerUnavailable)
    t = ProcessWorkerTransport(
        str(tmp_path), name="nocuda",
        env={"CUDA_VISIBLE_DEVICES": ""},
        config=TransportConfig(spawn_timeout_s=60.0))
    assert t.device is None
    with pytest.raises(WorkerUnavailable,
                       match="(?s)before binding.*CUDA is not available"):
        t.start()
    assert not t.live()
    assert not [f for f in os.listdir(t._workdir) if f.startswith("port.")]
    t.stop()


MIRROR = load_mirror("test_transport.py")

# the JAX module's own fixtures (its trained model and artifact)
globals().update(mirror_fixtures(MIRROR))


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_transport_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
