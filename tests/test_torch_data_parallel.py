"""The JAX package's ``tests/test_data_parallel.py`` case for case on the
port: its default data mesh is eight CPU ranks (the pool
``parallel.mesh.visible_devices`` draws from), as the JAX module's is the
eight forced host devices."""
import pytest
import torch

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,
                          port_on_cpu, run_mirror_case)  # noqa: F401

MIRROR = load_mirror("test_data_parallel.py")

globals().update(mirror_fixtures(MIRROR))

#: cases left out, each with its reason
SKIP = {
    # fits its params with the JAX package's jnp arrays; the port's
    # sharded_score is held to JAX's in test_torch_parallel.py
    "test_sharded_score_matches_local",
    # a JAX sharding of an XLA product; no port code runs
    "test_row_sharded_histogram_exact",
}


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_ranks():
    from transmogrifai_tpu_torch.parallel import mesh
    with pytest.MonkeyPatch.context() as mp:
        for k in ("TM_MESH_DEVICES", "TM_MESH_AXIS", "TM_MESH_RDMA_RING"):
            mp.delenv(k, raising=False)
        mp.setattr(mesh, "visible_devices",
                   lambda: [torch.device("cpu")] * 8)
        yield


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR, skip=SKIP))
def test_data_parallel_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
