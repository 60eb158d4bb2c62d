"""The JAX package's ``tests/test_continuum.py`` case for case on the port."""
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,
                          port_on_cpu, run_mirror_case)  # noqa: F401

MIRROR = load_mirror("test_continuum.py")

# the JAX module's own fixtures (its trained model, autouse resets)
globals().update(mirror_fixtures(MIRROR))


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_continuum_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
