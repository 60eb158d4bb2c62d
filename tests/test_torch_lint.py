"""The JAX package's ``tests/test_lint.py`` case for case on the port (the
opcheck static analyzer: the lint zoo, the train gate, construction
errors, export skew).

``tests/torch_mirror.py`` runs the JAX test's own text with its imports
pointed at ``transmogrifai_tpu_torch``, every case on the CPU; the
module's marks and fixtures come with it. SKIP names each case left
out, with its reason.
"""
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,  # noqa
                          one_torch_thread, port_on_cpu, run_mirror_case)

MIRROR = load_mirror("test_lint.py")
globals().update(mirror_fixtures(MIRROR))
pytestmark = getattr(MIRROR, "pytestmark", [])

#: case id -> why the port does not run it
SKIP = {
    'test_examples_lint_clean[3]':
        "the example modules import the JAX package, so this case lints "
        "a workflow built from the JAX package's classes; the port's "
        "analyzer does not read op_house_log's (the scaled response and "
        "its descaler) as clean. Built with the port's classes "
        "(chip_smoke.house_workflow) it lints clean",
}


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MIRROR) if p.id not in SKIP])
def test_lint_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
