"""The port's ``ops/parsers.py`` against the JAX package, and the JAX
package's ``tests/test_feature_ops.py`` case for case on the port.

Every parser stage is fitted (or applied) in both packages on the same
values, made from a numpy seed: the stage JSON, the output column and
every row of ``transform_value`` must be BITWISE equal (the module is
copied host code). Then each case of ``test_feature_ops.py`` runs on the
port's classes (``tests/torch_mirror.py``), the default device resolved
to the CPU.
"""
import base64

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)
from torch_parity import assert_same_stage, fit_both

N = 97


def _phones(rng):
    pool = ["(650) 123-4567", "+44 20 7946 0958", "+880 1712 345678",
            "12", "+999 123 4567", "+0 12", "650.555.0199", "+1-212-555-0100",
            "+49 30 901820", "+81 3-1234-5678", "not a phone", ""]
    return [None if rng.random() < 0.1 else pool[int(rng.integers(0,
            len(pool)))] for _ in range(N)]


def _emails(rng):
    doms = ["corp.com", "free.net", "mail.example.org", "x.io"]
    return [None if rng.random() < 0.1 else
            (f"user{int(rng.integers(0, 50))}@{doms[int(rng.integers(0, 4))]}"
             if rng.random() < 0.9 else "broken-address")
            for _ in range(N)]


def _urls(rng):
    doms = ["corp.com", "free.net", "www.example.org", "sub.x.io"]
    return [None if rng.random() < 0.1 else
            (f"https://{doms[int(rng.integers(0, 4))]}/p{int(rng.integers(9))}"
             if rng.random() < 0.85 else "ftp:/bad url")
            for _ in range(N)]


_MAGIC = [b"\x89PNG\r\n\x1a\n", b"%PDF-1.4\n", b"PK\x03\x04", b"GIF89a",
          b"\xff\xd8\xff\xe0", b"<?xml version='1.0'?><a/>", b"hello text",
          b"{\"a\": 1}", b"\x00\x01\x02\x03"]


def _base64(rng):
    return [None if rng.random() < 0.1 else base64.b64encode(
        _MAGIC[int(rng.integers(0, len(_MAGIC)))]
        + bytes(rng.integers(0, 256, 8).astype(np.uint8))).decode()
        for _ in range(N)]


def _dates(rng):
    return [None if rng.random() < 0.1 else
            int(rng.integers(1_400_000_000_000, 1_700_000_000_000))
            for _ in range(N)]


def _date_lists(rng):
    return [tuple(sorted(int(x) for x in rng.integers(
        1_500_000_000_000, 1_600_000_000_000, int(rng.integers(0, 5)))))
        for _ in range(N)]


def _labels(rng):
    return [None if rng.random() < 0.1 else f"c{int(rng.integers(0, 6))}"
            for _ in range(N)]


def _ints(rng):
    return [None if rng.random() < 0.1 else int(rng.integers(0, 7))
            for _ in range(N)]


# (class, kwargs, input type, value maker)
CASES = [
    ("PhoneNumberParser", {}, "Phone", _phones),
    ("PhoneNumberParser", {"default_region": "GB"}, "Phone", _phones),
    ("IsValidPhoneTransformer", {}, "Phone", _phones),
    ("PhoneToRegion", {}, "Phone", _phones),
    ("EmailToPickList", {}, "Email", _emails),
    ("EmailPrefixTransformer", {}, "Email", _emails),
    ("UrlToDomain", {}, "URL", _urls),
    ("IsValidUrlTransformer", {}, "URL", _urls),
    ("MimeTypeDetector", {}, "Base64", _base64),
    *[("TimePeriodTransformer", {"period": p}, "Date", _dates)
      for p in ("DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
                "MonthOfYear", "WeekOfMonth", "WeekOfYear")],
    *[("DateListVectorizerEstimator", {"pivot": p}, "DateList", _date_lists)
      for p in ("since", "mode_day", "mode_month", "mode_hour")],
    ("StringIndexer", {}, "PickList", _labels),
    ("IndexToString", {"labels": ["a", "b", "c"]}, "Integral", _ints),
    ("OneHotEncoder", {}, "Integral", _ints),
    ("AliasTransformer", {"name": "renamed"}, "Email", _emails),
    ("ToOccurTransformer", {}, "URL", _urls),
]


@pytest.mark.parametrize(
    "cls,kw,kind,make", CASES,
    ids=[f"{c}-{i}" for i, (c, *_rest) in enumerate(CASES)])
def test_parser_stage_bitwise_parity_with_jax(cls, kw, kind, make):
    values = make(np.random.default_rng(7))
    j, t = fit_both("ops.parsers", cls, kw, ["x"], {"x": (kind, values)})
    assert_same_stage(j, t)


def test_string_indexer_error_mode_and_deindex_parity():
    rng = np.random.default_rng(3)
    values = _labels(rng)
    j, t = fit_both("ops.parsers", "StringIndexer",
                    {"handle_invalid": "error"}, ["x"],
                    {"x": ("PickList", values)})
    assert_same_stage(j, t)
    labels = j[0].params["labels"]
    idx = [float(v) for v in rng.integers(0, len(labels) + 1, N)]
    j, t = fit_both("ops.parsers", "IndexToString", {"labels": labels},
                    ["x"], {"x": ("Real", idx)})
    assert_same_stage(j, t)


def test_drop_indices_by_parity():
    rng = np.random.default_rng(5)
    vec = [tuple(float(x) for x in rng.normal(size=5)) for _ in range(N)]
    j, t = fit_both("ops.parsers", "DropIndicesByTransformer",
                    {"drop_indices": [1, 3]}, ["x"], {"x": ("OPVector", vec)})
    assert_same_stage(j, t)


def test_parse_helpers_agree_with_jax():
    from transmogrifai_tpu.ops import parsers as J
    from transmogrifai_tpu_torch.ops import parsers as P
    rng = np.random.default_rng(9)
    for v in _phones(rng):
        assert P.parse_phone(v) == J.parse_phone(v)
        assert P.parse_phone_info(v) == J.parse_phone_info(v)
        assert P.phone_region(v) == J.phone_region(v)
    for v in _emails(rng):
        assert P.email_parts(v) == J.email_parts(v)
    for v in _urls(rng):
        assert P.url_domain(v) == J.url_domain(v)
    for v in _base64(rng):
        assert P.detect_mime(v) == J.detect_mime(v)
    for v in _dates(rng):
        for p in P.TIME_PERIODS:
            assert P.time_period(v, p) == J.time_period(v, p)


MIRROR = load_mirror("test_feature_ops.py")


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_feature_ops_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
