"""The JAX package's ``tests/test_stage_registry.py`` case for case on the
port (every registered stage class round-trips through the stage JSON
when default-constructed, or is allowlisted).

``tests/torch_mirror.py`` runs the JAX test's own text with its imports
pointed at ``transmogrifai_tpu_torch``, every case on the CPU; the
module's marks and fixtures come with it. SKIP names each case left
out, with its reason.
"""
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,  # noqa
                          one_torch_thread, port_on_cpu, run_mirror_case)

MIRROR = load_mirror("test_stage_registry.py")
globals().update(mirror_fixtures(MIRROR))
pytestmark = getattr(MIRROR, "pytestmark", [])

#: case id -> why the port does not run it
SKIP = {}


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MIRROR) if p.id not in SKIP])
def test_stage_registry_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
