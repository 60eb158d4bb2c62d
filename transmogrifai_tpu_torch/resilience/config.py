"""Strict environment-knob parsing, shared by every TM_* config surface.

The convention started with ``TM_FAULTS`` (a typo'd spec raises at
configure time — a drill that silently arms nothing proves nothing) and
was duplicated by hand for the ``TM_FLEET_*`` catalog. This
module is the one shared implementation, now also behind the continuum
loop's ``TM_DRIFT_*`` / ``TM_CONTINUUM_*`` knobs: an UNKNOWN variable
under a claimed prefix, or a value its field cannot parse, raises
ValueError instead of silently running defaults. The failure this
convention exists to prevent is quiet misconfiguration of a safety
mechanism — a typo'd ``TM_DRIFT_THRESHOLD`` must fail the deploy, not
silently disable the drift gate.

Catalog shape: ``{ENV_NAME: (config_field, parser)}``. The catalog IS
the validation surface — registering a knob here is what makes it
spellable at all.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["parse_env_fields"]


def parse_env_fields(prefix: str,
                     catalog: Dict[str, Tuple[str, Callable[[str], Any]]],
                     *, what: Optional[str] = None,
                     environ: Optional[Dict[str, str]] = None,
                     overrides: Optional[Dict[str, Any]] = None,
                     ignore: Tuple[str, ...] = ()
                     ) -> Dict[str, Any]:
    """Scan ``environ`` for ``prefix``-named knobs and parse them
    through ``catalog``; explicit ``overrides`` win over the
    environment. STRICT: any ``prefix``-named variable missing from the
    catalog, or a value the field's parser rejects, raises ValueError
    naming the variable — never a silent default.

    ``what`` labels the error messages (e.g. ``"fleet env var"``);
    defaults to ``"<prefix>* env var"``. ``ignore`` lists sub-prefixes
    under ``prefix`` owned by ANOTHER strict catalog (e.g. the
    ``TM_TRANSPORT_HEDGE_*`` catalog nests under ``TM_TRANSPORT_*``):
    those keys are skipped here, not rejected — the owning catalog
    still validates them strictly.
    """
    env = os.environ if environ is None else environ
    label = what or f"{prefix}* env var"
    fields: Dict[str, Any] = {}
    for key in sorted(env):
        if not key.startswith(prefix):
            continue
        if ignore and any(key.startswith(sub) for sub in ignore):
            continue
        if key not in catalog:
            raise ValueError(
                f"unknown {label} {key!r}; one of {sorted(catalog)}")
        field, parser = catalog[key]
        raw = env[key]
        try:
            fields[field] = parser(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"bad value {raw!r} for {key} (expected "
                f"{parser.__name__})") from None
    if overrides:
        fields.update(overrides)
    return fields
