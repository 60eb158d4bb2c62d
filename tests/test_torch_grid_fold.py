"""The JAX package's ``tests/test_grid_fold.py`` case for case on the port
(the grid-folded tree validation against the per-instance path, on one
device and on meshes; the cases that are not vmap or Pallas specific).
Its default meshes are eight CPU ranks (the pool
``parallel.mesh.visible_devices`` draws from), as the JAX module's are
the eight forced host devices.

``tests/torch_mirror.py`` runs the JAX test's own text with its imports
pointed at ``transmogrifai_tpu_torch``, every case on the CPU; the
module's marks and fixtures come with it. SKIP names each case left
out, with its reason.
"""
import pytest
import torch

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,  # noqa
                          one_torch_thread, port_on_cpu, run_mirror_case)

MIRROR = load_mirror("test_grid_fold.py")
globals().update(mirror_fixtures(MIRROR))
pytestmark = getattr(MIRROR, "pytestmark", [])

#: case id -> why the port does not run it
SKIP = {
    "test_folded_retry_chunks_match_full_batch":
        "reads the JAX PendingValidation's device_metrics; the port's "
        "retry halving is held by tests/test_torch_sweep.py and "
        "tests/test_torch_ft_transformer.py",
    "test_grow_tree_grid_matches_vmapped_grow_tree":
        "compares against a vmapped grow_tree, which the port does not "
        "have (its grower has the grid axis written out)",
    "test_grow_tree_grid_pallas_interpret_parity":
        "hands jax arrays to the grower and runs Pallas interpret mode",
    "test_single_tree_grid_exact_parity_with_shared_bins":
        "builds its reference with jax.vmap over jax arrays",
    "test_forest_folded_respects_num_trees_mask":
        "hands jax arrays (jnp) to the port's grower",
    "test_bf16_policy_shared_by_xla_and_pallas":
        "calls histogram_pallas_grid (Pallas; the port's histogram is "
        "held to its twin by tests/test_torch_hist_kernel.py)",
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


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MIRROR) if p.id not in SKIP])
def test_grid_fold_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
