"""Export a fitted workflow as a portable serving artifact (the port's
copy of ``transmogrifai_tpu/portable_export.py``).

Reference parity: the reference ships fitted models to non-Spark services
via MLeap (local/ module + MLeap runtime, SURVEY §2a Local scoring);
the artifact here plays the same role for the fused device chain, in
the JAX package's format, stamped complete by its ``_SUCCESS`` sentinel:

    manifest.json        the op IR
    params.npz           every fitted array
    portable_runtime.py  the numpy-only interpreter, copied verbatim
                         (``transmogrifai_tpu_torch/portable_runtime.py``)

    model.export_portable("serve_dir")
    scorer = portable.load("serve_dir").compile_scoring()

Raw-column scoring is exact when the whole workflow is device-able (all-
numeric pipelines). When host-only stages precede the device tail (text
pivots, hashing over strings), the manifest records them under
`hostPrefix` and the boundary columns are those stages' OUTPUTS, exactly
as the JAX package writes it, and every loader scores the boundary
columns: ``portable.from_portable`` on a device, the copied runtime
with numpy alone, and either package's loader reads the other's
artifacts.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from . import portable, portable_runtime
from .workflow import FusedScorer, WorkflowModel, _normalize_buckets


def export_portable(model: WorkflowModel, path: str,
                    buckets=None) -> Dict[str, str]:
    scorer = FusedScorer(model)
    score_buckets = _normalize_buckets(buckets)
    if not scorer.device_infos:
        raise ValueError("export_portable: no device-able stage tail — "
                         "nothing the portable runtime could interpret")
    stages_ir = []
    flat_arrays: Dict[str, np.ndarray] = {}
    for i, (in_names, _, out) in enumerate(scorer.device_infos):
        st = scorer.device_stage_by_output[out]
        spec = st.portable_spec()
        if spec is None:
            raise ValueError(
                f"export_portable: stage {type(st).__name__} (output "
                f"{out!r}) has a device fn but no portable_spec")
        spec = dict(spec)
        arrays = spec.pop("arrays", {})
        for key, val in portable.flatten_tree(arrays).items():
            flat_arrays[f"{i}/{key}"] = np.asarray(val)
        stages_ir.append({"out": out, "inputs": list(in_names), **spec})

    manifest = {
        "format": portable.FORMAT_VERSION,
        "boundary": list(scorer.boundary),
        "responseBoundary": sorted(scorer._response_boundary),
        "resultNames": list(scorer.result_names),
        "hostPrefix": [type(st).__name__ for st in scorer.host_stages],
        "stages": stages_ir,
    }
    if score_buckets is not None:
        # serving metadata: a loader rebuilds the same bucket set —
        # compile_scoring(buckets=model.score_buckets)
        manifest["scoreBuckets"] = list(score_buckets)
    # self-check BEFORE anything hits disk: the exporter must never
    # write an artifact its own skew gate (ModelRegistry's pre-publish
    # lint, TM-LINT-007/008) would reject on load
    from .lint import LintError, LintReport, check_export_manifest
    _report = LintReport(check_export_manifest(
        manifest, result_names=scorer.result_names))
    if _report.has_errors:
        raise LintError(_report, context=f"portable export for {path!r}")
    from .resilience import atomic
    os.makedirs(path, exist_ok=True)
    atomic.clear_complete(path)     # re-export: incomplete until stamped
    files = {}
    mpath = os.path.join(path, "manifest.json")
    atomic.atomic_write_json(mpath, manifest)
    files["manifest.json"] = mpath
    npath = os.path.join(path, "params.npz")
    atomic.atomic_write_npz(npath, flat_arrays)
    files["params.npz"] = npath
    rpath = os.path.join(path, "portable_runtime.py")
    with open(portable_runtime.__file__, "rb") as src:
        atomic.atomic_write_bytes(rpath, src.read())
    files["portable_runtime.py"] = rpath
    # every file is durably committed: stamp the artifact complete LAST
    # (loaders reject a sentinel-less dir — a crash anywhere above
    # leaves nothing that can serve)
    atomic.mark_complete(path)
    return files


def export_registry_version(model: WorkflowModel, root: str, version: str,
                            buckets=None, set_default: bool = True,
                            portable_only: bool = False) -> Dict[str, str]:
    """Export one model as a named VERSION under a registry root and
    refresh `registry.json` — the on-disk layout
    serving.ModelRegistry.from_dir() loads:

        root/
          registry.json       {"format": 1, "default": ..., "versions": ...}
          <version>/          one artifact dir per version
            manifest.json + params.npz + portable_runtime.py
            workflow.json + ... (unless portable_only)

    Each version dir carries BOTH artifact forms by default: the
    portable export and the saved workflow."""
    vdir = os.path.join(root, version)
    files = export_portable(model, vdir, buckets=buckets)
    if not portable_only:
        model.save(vdir)
        files["workflow.json"] = os.path.join(vdir, "workflow.json")
    files["registry.json"] = write_registry_manifest(
        root, default=version if set_default else None,
        fallback_exclude=None if set_default else version)
    return files


def write_registry_manifest(root: str, default: str = None,
                            fallback_exclude: str = None,
                            aliases: Dict[str, str] = None) -> str:
    """Scan `root` for version artifact dirs and (re)write
    registry.json. `default=None` keeps the previous manifest's default
    when that version still exists, else falls back to the
    lexicographically last version EXCEPT `fallback_exclude` — a
    version exported with set_default=False (a canary) must not win the
    fallback on a fresh or reset root just by sorting last."""
    prev_default = None
    man_path = os.path.join(root, "registry.json")
    if os.path.exists(man_path):
        try:
            with open(man_path) as f:
                prev_default = json.load(f).get("default")
        except (OSError, ValueError):
            prev_default = None
    versions: Dict[str, Any] = {}
    for entry in sorted(os.listdir(root)):
        vdir = os.path.join(root, entry)
        if not os.path.isdir(vdir):
            continue
        is_workflow = os.path.exists(os.path.join(vdir, "workflow.json"))
        is_portable = os.path.exists(os.path.join(vdir, "manifest.json"))
        if not (is_workflow or is_portable):
            continue
        info: Dict[str, Any] = {
            "path": entry,
            "kind": "workflow" if is_workflow else "portable",
        }
        if is_portable:
            with open(os.path.join(vdir, "manifest.json")) as f:
                pman = json.load(f)
            info["resultNames"] = pman.get("resultNames")
            if "scoreBuckets" in pman:
                info["scoreBuckets"] = pman["scoreBuckets"]
        versions[entry] = info
    if not versions:
        raise ValueError(f"{root}: no version artifact dirs to index")
    if default is None:
        if prev_default in versions:
            default = prev_default
        else:
            pool = [v for v in sorted(versions) if v != fallback_exclude]
            # an excluded-only root has no other candidate: a registry
            # needs SOME default, so the exclusion yields
            default = pool[-1] if pool else sorted(versions)[-1]
    elif default not in versions:
        raise ValueError(f"default version {default!r} not found under "
                         f"{root} (have {sorted(versions)})")
    doc = {"format": 1, "default": default, "versions": versions}
    if aliases:
        # {model id: version}: ids the serving registry registers as
        # aliases over the versions (read by ModelRegistry.from_dir)
        unknown = sorted(set(aliases.values()) - set(versions))
        if unknown:
            raise ValueError(f"aliases target unknown versions {unknown}")
        doc["aliases"] = dict(sorted(aliases.items()))
    from .resilience import atomic
    # tmp+fsync+rename: readers never see a half-written index, and the
    # index survives an OS crash right after the swap
    atomic.atomic_write_json(man_path, doc)
    return man_path
