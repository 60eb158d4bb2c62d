"""The JAX package's ``tests/test_multi_model.py`` case for case on the
port (multi-model, multi-tenant serving: per-request model ids,
co-batching, fair queueing, tenant budgets, the model cache).

``tests/torch_mirror.py`` runs the JAX test's own text with its imports
pointed at ``transmogrifai_tpu_torch``, every case on the CPU; the
module's marks and fixtures come with it. SKIP names each case left
out, with its reason.
"""
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,  # noqa
                          one_torch_thread, port_on_cpu, run_mirror_case)

MIRROR = load_mirror("test_multi_model.py")
globals().update(mirror_fixtures(MIRROR))
pytestmark = getattr(MIRROR, "pytestmark", [])

#: case id -> why the port does not run it
SKIP = {
    'test_threaded_multi_model_bitwise_vs_solo[0]':
        'builds EngineConfig(cross_model=True): the port has one '
        'request plane and no cross_model option (its default '
        'co-batches across models, which the other cases here hold)',
    'test_threaded_multi_model_bitwise_vs_solo[1]':
        "builds EngineConfig(cross_model=False), the JAX package's "
        'serial bench baseline, which the port does not have',
    'test_tenant_knobs_strict_and_weights_spec':
        "sets TM_MODEL_CROSS_BATCH, which the port's strict parse "
        'rejects (no cross_model option); the tenant weights and queue '
        "budgets are held by this mirror's WFQ and budget cases",
}


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MIRROR) if p.id not in SKIP])
def test_multi_model_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
