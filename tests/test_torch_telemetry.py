"""The port's ``/metricsz`` exposition against the JAX package's: the
same status document renders to the same bytes, and a port engine's and
fleet's documents carry the JAX package's families; then the JAX
package's ``tests/test_telemetry.py`` case for case on the port."""
import json

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,
                          port_on_cpu, run_mirror_case)  # noqa: F401


def _texts(doc):
    from transmogrifai_tpu.telemetry.metrics import prometheus_text as J
    from transmogrifai_tpu_torch.telemetry.metrics import (
        prometheus_text as P)
    # each package renders its own copy of the document
    return J(json.loads(json.dumps(doc))), P(json.loads(json.dumps(doc)))


def _port_served(replicas=None):
    """A started port engine (or fleet of ``replicas``) serving the
    serving suites' model on the CPU, after a few requests."""
    util = load_mirror("serving_util.py")
    from transmogrifai_tpu_torch.serving import (FleetConfig, ServingEngine,
                                                 ServingFleet)
    model, ds, _name = util.train_small_serving_model(3)
    if replicas:
        server = ServingFleet(model, replicas=replicas, buckets=(16,),
                              config=FleetConfig(replicas=replicas),
                              device="cpu")
    else:
        server = ServingEngine(model, buckets=(16,), device="cpu")
    server.start()
    for n in (1, 5, 9):
        cols = {k: ds.column(k)[:n] for k in ds.column_names}
        server.score(type(ds)(cols, {k: ds.ftype(k)
                                     for k in ds.column_names}), timeout=60)
    return server


@pytest.mark.parametrize("replicas", [None, 2], ids=["engine", "fleet"])
def test_prometheus_text_identical_across_packages(replicas, port_on_cpu):
    server = _port_served(replicas)
    try:
        doc = server.status()
    finally:
        server.stop()
    jax_text, port_text = _texts(doc)
    assert port_text == jax_text
    assert "tm_engine_completed_total" in port_text
    if replicas:
        assert "tm_fleet_" in port_text
    # the port's own block rides the document, not the exposition
    assert "device" in (doc if not replicas else
                        doc["replicas"]["r0"])


def test_prometheus_text_of_a_jax_document_identical():
    """A JAX engine's status document, rendered by both packages."""
    from serving_util import train_small_serving_model
    from transmogrifai_tpu.serving import ServingEngine
    model, ds, _name = train_small_serving_model(3)
    with ServingEngine(model, buckets=(16,)) as eng:
        eng.score(ds, timeout=120)
        doc = eng.status()
    jax_text, port_text = _texts(doc)
    assert port_text == jax_text


def test_port_status_device_block_and_caches(port_on_cpu):
    server = _port_served()
    try:
        doc = server.status()
    finally:
        server.stop()
    assert doc["device"]["device"] == "cpu"
    # the CPU path launches no kernel
    assert set(doc["device"]["kernels"]) == {"fused_linear_scores",
                                             "tree_histogram"}
    scoring = next(iter(doc["scoring"].values()))
    assert scoring["total_compiles"] == 1       # one bucket, warmed once
    assert np.isfinite(doc["engine"]["wait_p99_ms"])


MIRROR = load_mirror("test_telemetry.py")

# the JAX module's own fixtures (its trained models, autouse resets)
globals().update(mirror_fixtures(MIRROR))


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_telemetry_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
