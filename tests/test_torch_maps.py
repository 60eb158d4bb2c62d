"""The port's ``ops/maps.py`` against the JAX package, and the JAX
package's ``tests/test_maps_extended.py`` case for case on the port.

``default_map_vectorizer`` picks the same vectorizer class for every map
type in both packages; each of them is fitted in both packages on the
same maps (numpy seed), on both encoder paths — the vectorized
``_vectorize`` (default) and the per-row ``_vectorize_rows`` that
``TM_VECTORIZE=0`` selects — and the stage JSON (keys, fills, labels),
the output column and every row of ``transform_value`` must be BITWISE
equal. The two paths must agree with each other too.
"""
import base64

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)
from torch_parity import assert_same_stage, fit_both

N = 83
KEYS = [f"k{i}" for i in range(6)]
_WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


def _value(kind, rng, i):
    if kind in ("RealMap", "CurrencyMap", "PercentMap"):
        return float("nan") if rng.random() < 0.04 else float(rng.normal(3, 2))
    if kind == "IntegralMap":
        return int(rng.integers(-50, 50))
    if kind in ("DateMap", "DateTimeMap"):
        return int(rng.integers(1_400_000_000_000, 1_700_000_000_000))
    if kind == "BinaryMap":
        return bool(rng.random() < 0.4)
    if kind == "MultiPickListMap":
        return frozenset(f"t{int(t)}" for t in
                         rng.integers(0, 9, int(rng.integers(0, 4))))
    if kind == "GeolocationMap":
        return (float(rng.uniform(-80, 80)), float(rng.uniform(-170, 170)),
                float(rng.integers(1, 6)))
    if kind == "EmailMap":
        return f"u{int(rng.integers(0, 9))}@d{int(rng.integers(0, 3))}.com"
    if kind == "URLMap":
        return f"https://d{int(rng.integers(0, 4))}.org/p"
    if kind == "PhoneMap":
        return ["(650) 123-4567", "+44 20 7946 0958", "12"][
            int(rng.integers(0, 3))]
    if kind == "Base64Map":
        return base64.b64encode(bytes(rng.integers(0, 256, 6).astype(
            np.uint8))).decode()
    if kind == "TextAreaMap":
        return " ".join(rng.choice(_WORDS, int(rng.integers(1, 7)))) + (
            f" w{i}" if rng.random() < 0.5 else "")
    # the other TextMap kinds: short categorical strings
    return f"v{int(rng.integers(0, 7))}"


def _maps(kind, seed=41, presence=0.7):
    rng = np.random.default_rng(seed)
    return [{k: _value(kind, rng, i) for k in KEYS
             if rng.random() < presence} for i in range(N)]


MAP_KINDS = ["TextMap", "EmailMap", "PhoneMap", "URLMap", "IDMap",
             "PickListMap", "ComboBoxMap", "Base64Map", "TextAreaMap",
             "CityMap", "StreetMap", "StateMap", "CountryMap",
             "PostalCodeMap", "RealMap", "CurrencyMap", "PercentMap",
             "IntegralMap", "DateMap", "DateTimeMap", "BinaryMap",
             "MultiPickListMap", "GeolocationMap"]


def test_default_map_vectorizer_dispatch_matches_jax():
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu.ops.maps import default_map_vectorizer as jdmv
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops.maps import default_map_vectorizer
    for kind in MAP_KINDS + ["Prediction", "Real", "Text"]:
        j, t = jdmv(getattr(jft, kind)), default_map_vectorizer(
            getattr(ft, kind))
        assert type(t).__name__ == type(j).__name__, kind
        if j is not None:
            assert t.params == j.params


@pytest.mark.parametrize("vectorize", ["1", "0"])
@pytest.mark.parametrize("kind", MAP_KINDS)
def test_default_map_vectorizer_bitwise_parity_with_jax(kind, vectorize,
                                                        monkeypatch):
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu.ops.maps import default_map_vectorizer as jdmv
    monkeypatch.setenv("TM_VECTORIZE", vectorize)
    cls = type(jdmv(getattr(jft, kind))).__name__
    j, t = fit_both("ops.maps", cls, {}, ["m"], {"m": (kind, _maps(kind))})
    assert_same_stage(j, t)


# (class, kwargs, map type)
OPTION_CASES = [
    ("RealMapVectorizer", {"fill_with": "zero", "track_nulls": False},
     "RealMap"),
    ("RealMapVectorizer", {"allow_keys": ["k0", "k2"]}, "RealMap"),
    ("BinaryMapVectorizer", {"deny_keys": ["k1"]}, "BinaryMap"),
    ("TextMapPivotVectorizer", {"top_k": 3, "other_track": False},
     "PickListMap"),
    ("TextMapPivotVectorizer", {"top_k": 2, "track_nulls": False},
     "MultiPickListMap"),
    ("GeolocationMapVectorizer", {"track_nulls": False}, "GeolocationMap"),
    ("DateMapVectorizer", {"time_period": "HourOfDay"}, "DateMap"),
    ("DateMapVectorizer", {"time_period": "DayOfMonth",
                           "deny_keys": ["k3"]}, "DateTimeMap"),
    ("SmartTextMapVectorizer", {"max_cardinality": 5, "num_bins": 16},
     "TextAreaMap"),
    ("SmartTextMapVectorizer", {"max_cardinality": 200, "top_k": 4},
     "TextMap"),
    ("FilterMapTransformer", {"allow_keys": ["k0", "k4", "k5"]}, "RealMap"),
    ("FilterMapTransformer", {"deny_keys": ["k2"]}, "PickListMap"),
]


@pytest.mark.parametrize("vectorize", ["1", "0"])
@pytest.mark.parametrize(
    "cls,kw,kind", OPTION_CASES,
    ids=[f"{c}-{i}" for i, (c, *_r) in enumerate(OPTION_CASES)])
def test_map_stage_options_bitwise_parity_with_jax(cls, kw, kind, vectorize,
                                                   monkeypatch):
    monkeypatch.setenv("TM_VECTORIZE", vectorize)
    j, t = fit_both("ops.maps", cls, kw, ["m"],
                    {"m": (kind, _maps(kind, seed=43))})
    assert_same_stage(j, t)


@pytest.mark.parametrize("kind", ["RealMap", "PickListMap", "DateMap",
                                  "TextAreaMap", "GeolocationMap",
                                  "BinaryMap", "MultiPickListMap"])
def test_vectorized_and_row_paths_agree_on_the_port(kind, monkeypatch):
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu.ops.maps import default_map_vectorizer as jdmv
    cls = type(jdmv(getattr(jft, kind))).__name__
    outs = []
    for v in ("1", "0"):
        monkeypatch.setenv("TM_VECTORIZE", v)
        _, (tm, tout, _) = fit_both("ops.maps", cls, {}, ["m"],
                                    {"m": (kind, _maps(kind, seed=47))})
        outs.append(tout.column(tm.output.name))
    assert np.array_equal(outs[0], outs[1], equal_nan=True)


MIRROR = load_mirror("test_maps_extended.py")


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_maps_extended_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
