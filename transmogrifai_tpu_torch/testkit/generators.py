"""Seeded random value streams per feature type.

Reference: testkit/.../testkit/Random*.scala — infinite deterministic
streams with `probability_of_empty`; `take(n)` yields raw python values
(the canonical cell representation for Dataset columns).

The port's copy of ``transmogrifai_tpu/testkit/generators.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

import string
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..features import types as ft


_default_seed_counter = 1000


def _next_default_seed() -> int:
    """Distinct (but deterministic, construction-ordered) default seeds so
    two streams built without explicit seeds are NOT identical copies."""
    global _default_seed_counter
    _default_seed_counter += 1
    return _default_seed_counter


class RandomStream:
    """Stream semantics: `take(n)` ADVANCES the stream (two successive
    takes give different values); `reset()` rewinds; a fresh stream with
    the same explicit seed reproduces the same sequence."""

    def __init__(self, sample: Callable[[np.random.Generator], Any],
                 wtype=ft.FeatureType, seed: Optional[int] = None,
                 probability_of_empty: float = 0.0):
        self._sample = sample
        self.wtype = wtype
        self.seed = _next_default_seed() if seed is None else seed
        self.probability_of_empty = probability_of_empty
        self._rng = np.random.default_rng(self.seed)

    def with_probability_of_empty(self, p: float) -> "RandomStream":
        return RandomStream(self._sample, self.wtype, self.seed, p)

    def with_seed(self, seed: int) -> "RandomStream":
        return RandomStream(self._sample, self.wtype, seed,
                            self.probability_of_empty)

    def reset(self) -> "RandomStream":
        self._rng = np.random.default_rng(self.seed)
        return self

    def _sample_one(self, rng: np.random.Generator) -> Any:
        if (self.probability_of_empty > 0
                and rng.random() < self.probability_of_empty):
            return None
        return self._sample(rng)

    def take(self, n: int) -> List[Any]:
        return [self._sample_one(self._rng) for _ in range(n)]

    def limit(self, n: int) -> List[Any]:  # scala-style alias
        return self.take(n)


class RandomReal:
    @staticmethod
    def normal(mean: float = 0.0, sigma: float = 1.0,
               wtype=ft.Real, seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: float(r.normal(mean, sigma)),
                            wtype, seed)

    @staticmethod
    def uniform(low: float = 0.0, high: float = 1.0,
                wtype=ft.Real, seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: float(r.uniform(low, high)),
                            wtype, seed)

    @staticmethod
    def poisson(lam: float = 3.0, wtype=ft.Real, seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: float(r.poisson(lam)), wtype, seed)

    @staticmethod
    def lognormal(mean: float = 0.0, sigma: float = 1.0,
                  wtype=ft.Real, seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: float(r.lognormal(mean, sigma)),
                            wtype, seed)


class RandomIntegral:
    @staticmethod
    def integers(low: int = 0, high: int = 100, wtype=ft.Integral,
                 seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: int(r.integers(low, high)), wtype, seed)

    @staticmethod
    def dates(start: int = 1_500_000_000_000, step_ms: int = 86_400_000,
              seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: int(start + r.integers(0, 365) * step_ms),
            ft.Date, seed)


class RandomBinary:
    @staticmethod
    def of(probability_of_true: float = 0.5, seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: bool(r.random() < probability_of_true),
                            ft.Binary, seed)


def _rand_word(r: np.random.Generator, lo: int, hi: int) -> str:
    n = int(r.integers(lo, hi + 1))
    letters = string.ascii_lowercase
    return "".join(letters[int(i)] for i in r.integers(0, 26, n))


class RandomText:
    @staticmethod
    def strings(min_len: int = 3, max_len: int = 10, wtype=ft.Text,
                seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: _rand_word(r, min_len, max_len),
                            wtype, seed)

    @staticmethod
    def text_areas(min_words: int = 3, max_words: int = 12,
                   seed: Optional[int] = None) -> RandomStream:
        def sample(r):
            k = int(r.integers(min_words, max_words + 1))
            return " ".join(_rand_word(r, 2, 9) for _ in range(k))
        return RandomStream(sample, ft.TextArea, seed)

    @staticmethod
    def picklists(domain: Sequence[str], wtype=ft.PickList,
                  seed: Optional[int] = None) -> RandomStream:
        domain = list(domain)
        return RandomStream(lambda r: domain[int(r.integers(0, len(domain)))],
                            wtype, seed)

    @staticmethod
    def emails(domain: str = "example.com", seed: Optional[int] = None) -> RandomStream:
        return RandomStream(lambda r: f"{_rand_word(r, 4, 9)}@{domain}",
                            ft.Email, seed)

    @staticmethod
    def phones(seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: "+1" + "".join(str(int(d))
                                     for d in r.integers(0, 10, 10)),
            ft.Phone, seed)

    @staticmethod
    def urls(domain: str = "example.com", seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: f"https://{domain}/{_rand_word(r, 3, 8)}",
            ft.URL, seed)

    @staticmethod
    def ids(seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: "id_" + "".join(str(int(d))
                                      for d in r.integers(0, 10, 8)),
            ft.ID, seed)

    @staticmethod
    def countries(seed: Optional[int] = None) -> RandomStream:
        return RandomText.picklists(
            ["USA", "Mexico", "Canada", "France", "Japan", "Brazil"],
            wtype=ft.Country, seed=seed)

    @staticmethod
    def postal_codes(seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: "".join(str(int(d)) for d in r.integers(0, 10, 5)),
            ft.PostalCode, seed)

    @staticmethod
    def base64(min_len: int = 8, max_len: int = 32,
               seed: Optional[int] = None) -> RandomStream:
        import base64 as b64

        def sample(r):
            n = int(r.integers(min_len, max_len + 1))
            return b64.b64encode(bytes(r.integers(0, 256, n).astype(
                np.uint8))).decode()
        return RandomStream(sample, ft.Base64, seed)


class RandomList:
    @staticmethod
    def of_texts(min_len: int = 0, max_len: int = 5,
                 seed: Optional[int] = None) -> RandomStream:
        def sample(r):
            k = int(r.integers(min_len, max_len + 1))
            return tuple(_rand_word(r, 3, 8) for _ in range(k))
        return RandomStream(sample, ft.TextList, seed)

    @staticmethod
    def of_dates(start: int = 1_500_000_000_000, min_len: int = 0,
                 max_len: int = 5, seed: Optional[int] = None) -> RandomStream:
        def sample(r):
            k = int(r.integers(min_len, max_len + 1))
            return tuple(int(start + d) for d in
                         r.integers(0, 10_000_000, k))
        return RandomStream(sample, ft.DateList, seed)


class RandomMultiPickList:
    @staticmethod
    def of(domain: Sequence[str], min_size: int = 0, max_size: int = 3,
           seed: Optional[int] = None) -> RandomStream:
        domain = list(domain)
        hi = min(max_size, len(domain))
        if min_size > hi:
            raise ValueError(
                f"min_size={min_size} exceeds min(max_size, |domain|)={hi}")

        def sample(r):
            k = int(r.integers(min_size, hi + 1))
            idx = r.choice(len(domain), size=k, replace=False)
            return frozenset(domain[int(i)] for i in idx)
        return RandomStream(sample, ft.MultiPickList, seed)


class RandomMap:
    @staticmethod
    def of(value_stream: RandomStream, min_size: int = 1, max_size: int = 4,
           key_prefix: str = "k", wtype: Optional[type] = None,
           seed: Optional[int] = None) -> RandomStream:
        vtype = wtype or _map_type_for(value_stream.wtype)

        def sample(r):
            k = int(r.integers(min_size, max_size + 1))
            out = {}
            for i in range(k):
                # the value stream's probability_of_empty maps to KEY
                # OMISSION (OPMaps carry no nulls: missing key = missing)
                v = value_stream._sample_one(r)
                if v is not None:
                    out[f"{key_prefix}{i}"] = v
            return out
        return RandomStream(sample, vtype, seed)


def _map_type_for(scalar: type) -> type:
    name = scalar.__name__ + "Map"
    try:
        return ft.FeatureTypeFactory.by_name(name)
    except ft.FeatureTypeError:
        raise ValueError(
            f"no OPMap counterpart registered for {scalar.__name__}; "
            f"pass wtype= explicitly to RandomMap.of") from None


class RandomVector:
    @staticmethod
    def dense(length: int, mean: float = 0.0, sigma: float = 1.0,
              seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: tuple(float(x) for x in r.normal(mean, sigma, length)),
            ft.OPVector, seed)


class RandomGeolocation:
    @staticmethod
    def of(seed: Optional[int] = None) -> RandomStream:
        return RandomStream(
            lambda r: (float(r.uniform(-90, 90)), float(r.uniform(-180, 180)),
                       float(r.integers(1, 10))),
            ft.Geolocation, seed)
