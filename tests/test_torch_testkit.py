"""The port's ``testkit/`` against the JAX package, and the JAX package's
``tests/test_testkit.py`` case for case on the port.

Every generator draws the same values in both packages for the same
seed (the streams are numpy, copied), ``TestFeatureBuilder`` builds the
same columns, and the spec bases hold the port's stages to their
contracts, the FT-Transformer's included.
"""
import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)


def _streams(tk, ft):
    return {
        "normal": tk.RandomReal.normal(2.0, 3.0, seed=1),
        "uniform": tk.RandomReal.uniform(-1, 1, seed=2),
        "poisson": tk.RandomReal.poisson(4.0, seed=3),
        "lognormal": tk.RandomReal.lognormal(seed=4),
        "ints": tk.RandomIntegral.integers(0, 50, seed=5),
        "dates": tk.RandomIntegral.dates(seed=6),
        "binary": tk.RandomBinary.of(0.3, seed=7),
        "strings": tk.RandomText.strings(seed=8),
        "areas": tk.RandomText.text_areas(seed=9),
        "picks": tk.RandomText.picklists(["a", "b", "c"], seed=10),
        "emails": tk.RandomText.emails(seed=11),
        "phones": tk.RandomText.phones(seed=12),
        "urls": tk.RandomText.urls(seed=13),
        "ids": tk.RandomText.ids(seed=14),
        "countries": tk.RandomText.countries(seed=15),
        "postal": tk.RandomText.postal_codes(seed=16),
        "b64": tk.RandomText.base64(seed=17),
        "texts": tk.RandomList.of_texts(seed=18),
        "datelists": tk.RandomList.of_dates(seed=19),
        "mpl": tk.RandomMultiPickList.of(["x", "y", "z", "w"], seed=20),
        "realmap": tk.RandomMap.of(tk.RandomReal.normal(seed=21), seed=22),
        "textmap": tk.RandomMap.of(tk.RandomText.strings(seed=23), seed=24),
        "vectors": tk.RandomVector.dense(4, seed=25),
        "geo": tk.RandomGeolocation.of(seed=26),
        "sparse": tk.RandomReal.normal(seed=27)
        .with_probability_of_empty(0.4),
    }


def test_generators_draw_the_jax_packages_values():
    import transmogrifai_tpu.testkit as J
    import transmogrifai_tpu_torch.testkit as P
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu_torch.features import types as ft
    js, ps = _streams(J, jft), _streams(P, ft)
    for name in js:
        a, b = js[name].take(60), ps[name].take(60)
        assert repr(b) == repr(a), name
        assert ps[name].wtype.__name__ == js[name].wtype.__name__, name
        assert repr(ps[name].reset().take(5)) == repr(a[:5]), name


def test_feature_builder_random_matches_jax():
    import transmogrifai_tpu.testkit as J
    import transmogrifai_tpu_torch.testkit as P
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu_torch.features import types as ft
    from torch_parity import assert_same_column, reset_uids
    reset_uids()
    jds, jfs = J.TestFeatureBuilder.random(
        {k: v for k, v in _streams(J, jft).items()
         if k in ("normal", "picks", "emails", "realmap", "geo")}, n=40)
    pds, pfs = P.TestFeatureBuilder.random(
        {k: v for k, v in _streams(P, ft).items()
         if k in ("normal", "picks", "emails", "realmap", "geo")}, n=40)
    assert pds.column_names == jds.column_names
    for name in jds.column_names:
        assert_same_column(jds, pds, name)
    assert [f.name for f in pfs.values()] == [f.name for f in jfs.values()]


MIRROR = load_mirror("test_testkit.py")


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_testkit_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
