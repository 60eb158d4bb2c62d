"""The completeness sentinel every artifact loader checks.

The port only READS artifacts in this slice, so it keeps the loader
half of ``transmogrifai_tpu.resilience.atomic``: :data:`SENTINEL`
(``_SUCCESS``, written LAST by the JAX package's atomic exporter) and
:func:`require_complete`, which rejects a sentinel-less dir with
:class:`IncompleteArtifactError` naming what to do.
"""
from __future__ import annotations

import os

#: completeness marker written LAST into a multi-file artifact dir
SENTINEL = "_SUCCESS"


class IncompleteArtifactError(ValueError):
    """A multi-file artifact dir without its completeness sentinel: the
    save crashed mid-way (or the dir was built by hand) — loading it
    could serve a torn model."""


def is_complete(dir_path: str) -> bool:
    return os.path.exists(os.path.join(dir_path, SENTINEL))


def require_complete(dir_path: str, what: str = "artifact") -> None:
    """Loud gate for loaders: a dir without the sentinel was never
    fully saved (crash mid-save) or predates/bypasses the atomic
    writers — either way it must not load as a model."""
    if not is_complete(dir_path):
        raise IncompleteArtifactError(
            f"{dir_path}: {what} has no {SENTINEL} completeness sentinel "
            f"— the save did not finish (crashed mid-write?) or the dir "
            f"predates / bypassed the atomic export path. Re-export the "
            f"artifact rather than serving a possibly-torn model; for a "
            f"LEGACY artifact you have verified by hand, create an empty "
            f"{SENTINEL} file in the dir to migrate it")
