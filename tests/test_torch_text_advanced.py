"""The port's text layer against the JAX package: ``ops/analyzers.py``,
``ops/ner.py`` / ``ops/ner_data.py``, ``ops/text_advanced.py``,
sensitive-name detection (``ops/sensitive.py``) and ``ops/lda.py``; and
the JAX package's ``test_text_completeness.py``, ``test_analyzers.py``
and ``test_ner_tagger.py`` case for case on the port.

Host stages are copied code and held BITWISE: analyzers and stemmers
token for token, the NER tagger's trained weights (it trains on first
use from ``random`` with a fixed seed) and its entities, language
detection, and every text stage's JSON, column and rows.

``OpLDA`` is rewritten in torch. Given the JAX package's initial
``lam0`` (``jax.random.gamma``, which torch cannot reproduce), the fit
must match the JAX fit to the tolerance below, measured on the CPU: f32
digamma/exp rounding compounds over 30 EM x 20 E-steps to at most
~5e-4 relative on lambda entries near ``eta`` and ~3.2e-7 of max|lambda|
absolute, ~1e-6 absolute on topic proportions. So lambda is held at
rtol 1e-4 + atol 1e-6 * max|lambda| and proportions at rtol 1e-4 +
atol 1e-6; one E-step or one EM step fewer, or a wrong digamma, moves
them by orders of magnitude more and must fail. With its own draws
(a CPU ``torch.Generator``) the port is held to quality: the JAX test's
two-topic corpus separates.
"""
import numpy as np
import pytest
import torch

from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)
from torch_parity import assert_same_stage, fit_both, jax_lam0

LAM_RTOL, LAM_ATOL_SCALE = 1e-4, 1e-6
TOPIC_RTOL, TOPIC_ATOL = 1e-4, 1e-6

SAMPLES = [
    "The quick brown foxes were running over the lazy dogs' houses",
    "Les enfants mangeaient des pommes dans les jardins fleuris",
    "Los niños estaban corriendo por las calles de la ciudad",
    "Die Kinder spielten gestern fröhlich in den großen Gärten",
    "I bambini mangiavano le mele nei giardini della nonna",
    "As crianças estavam correndo pelas ruas da cidade antiga",
    "De kinderen speelden gisteren vrolijk in de grote tuinen",
    "Barnen lekte glatt i de stora trädgårdarna igår",
    "Børnene legede glade i de store haver i går",
    "Lapset leikkivät iloisesti suurissa puutarhoissa eilen",
    "Дети весело играли вчера в больших садах",
    "子供たちは昨日大きな庭で楽しく遊んだ",
    "孩子们昨天在大花园里快乐地玩耍",
    "아이들은 어제 큰 정원에서 즐겁게 놀았다",
    "الأطفال لعبوا بسعادة في الحدائق الكبيرة",
    "Dr. Maria Gonzalez met John Smith of Acme Corp in Paris last May",
    "Mr. London said the Ministry of Finance in Berlin would respond",
    "", "1234 5678", "ok",
]
LANGS = ["en", "es", "fr", "de", "it", "pt", "nl", "sv", "da", "fi", "ru"]


@pytest.mark.parametrize("lang", LANGS + ["auto", None])
def test_tokenize_with_a_language_matches_jax(lang):
    from transmogrifai_tpu.ops.text import tokenize as jtok
    from transmogrifai_tpu_torch.ops.text import tokenize
    for text in SAMPLES:
        for stop, stem in ((True, False), (False, True), (True, True)):
            assert tokenize(text, language=lang, remove_stopwords=stop,
                            stem=stem) == jtok(text, language=lang,
                                               remove_stopwords=stop,
                                               stem=stem)


def test_analyzers_match_jax_word_for_word():
    from transmogrifai_tpu.ops import analyzers as J
    from transmogrifai_tpu_torch.ops import analyzers as P
    assert P.STOPWORDS == J.STOPWORDS
    assert sorted(P._STEMMERS) == sorted(J._STEMMERS)
    words = sorted({w for s in SAMPLES for w in s.lower().split()}
                   | set().union(*J.STOPWORDS.values()))
    for lang in J._STEMMERS:
        for w in words:
            assert P._STEMMERS[lang](w) == J._STEMMERS[lang](w), (lang, w)
        assert P.analyze_tokens(words, lang) == J.analyze_tokens(words, lang)


def test_detect_language_matches_jax():
    from transmogrifai_tpu.ops.text_advanced import detect_language as jd
    from transmogrifai_tpu_torch.ops.text_advanced import detect_language
    for text in SAMPLES + [None]:
        assert detect_language(text) == jd(text)


def test_ner_tagger_trains_bit_for_bit_and_tags_alike():
    from transmogrifai_tpu.ops import ner as J
    from transmogrifai_tpu_torch.ops import ner as P
    jt, tt = J.get_tagger(), P.get_tagger()
    assert tt.model.weights == jt.model.weights
    for text in SAMPLES:
        assert P.find_entities(text) == J.find_entities(text)
        toks = J._tokenize(text)
        assert P.tag_tokens(toks) == J.tag_tokens(toks)


def test_name_lexicons_and_detection_match_jax():
    from transmogrifai_tpu.ops import sensitive as J
    from transmogrifai_tpu_torch.ops import sensitive as P
    assert P._lexicons() == J._lexicons()
    names = ["Ann Lee", "Mr Coffee maker", "Miss Kwame Acheampong",
             "Dr. Maria Gonzalez", "john smith", "Acme Corp", "", None,
             "Mrs. O'Neil-Smith", "the end", "Bob"]
    for v in names:
        assert P.looks_like_name(v) == J.looks_like_name(v)
        assert P.name_stats(v) == J.name_stats(v)


def _texts(rng, n=73):
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "th"]
    return [None if rng.random() < 0.08 else " ".join(
        rng.choice(words, int(rng.integers(1, 8)))) for _ in range(n)]


def _text_lists(rng, n=73):
    words = ["red", "green", "blue", "cyan", "magenta", "ochre"]
    return [tuple(rng.choice(words, int(rng.integers(0, 6))))
            for _ in range(n)]


def _names(rng, n=73):
    first = ["Ann", "Bob", "Maria", "John", "Li", "Kwame", "Sofia"]
    last = ["Lee", "Smith", "Gonzalez", "Acheampong", "Novak", "Chen"]
    other = ["Acme Corp", "blue widget", "n/a", "Mr Coffee maker"]
    return [None if rng.random() < 0.05 else (
        f"{first[int(rng.integers(0, 7))]} {last[int(rng.integers(0, 6))]}"
        if rng.random() < 0.8 else other[int(rng.integers(0, 4))])
        for _ in range(n)]


# (module, class, kwargs, input type, value maker)
STAGES = [
    ("ops.text_advanced", "CountVectorizer", {}, "Text", _texts),
    ("ops.text_advanced", "CountVectorizer", {"vocab_size": 4,
                                              "binary": True}, "Text",
     _texts),
    ("ops.text_advanced", "CountVectorizer", {"min_doc_freq": 3},
     "TextList", _text_lists),
    ("ops.text_advanced", "TfIdfVectorizer", {}, "Text", _texts),
    ("ops.text_advanced", "NGramTransformer", {"n": 2}, "Text", _texts),
    ("ops.text_advanced", "NGramTransformer", {"n": 3, "separator": "_"},
     "TextList", _text_lists),
    ("ops.text_advanced", "TextLenTransformer", {}, "Text", _texts),
    ("ops.text_advanced", "TextLenTransformer", {}, "TextList", _text_lists),
    ("ops.text_advanced", "LangDetector", {}, "Text",
     lambda rng: [SAMPLES[int(i)] for i in rng.integers(0, len(SAMPLES),
                                                        40)]),
    ("ops.text_advanced", "Word2VecEstimator", {"dim": 8, "vocab_size": 16},
     "Text", _texts),
    ("ops.ner", "NameEntityRecognizer", {}, "Text",
     lambda rng: [SAMPLES[int(i)] for i in rng.integers(0, len(SAMPLES),
                                                        30)]),
    ("ops.sensitive", "HumanNameDetector", {}, "Text", _names),
    ("ops.text", "TextTokenizer", {"language": "auto",
                                   "remove_stopwords": True, "stem": True},
     "Text", lambda rng: [SAMPLES[int(i)] for i in rng.integers(
         0, len(SAMPLES), 40)]),
]


@pytest.mark.parametrize(
    "module,cls,kw,kind,make", STAGES,
    ids=[f"{c}-{i}" for i, (_m, c, *_r) in enumerate(STAGES)])
def test_text_stage_bitwise_parity_with_jax(module, cls, kw, kind, make):
    j, t = fit_both(module, cls, kw, ["x"],
                    {"x": (kind, make(np.random.default_rng(13)))})
    assert_same_stage(j, t)


def test_set_ngram_similarity_parity():
    rng = np.random.default_rng(19)
    cols = {"a": ("TextList", _text_lists(rng)),
            "b": ("TextList", _text_lists(rng))}
    j, t = fit_both("ops.text_advanced", "SetNGramSimilarity", {"n": 2},
                    ["a", "b"], cols)
    assert_same_stage(j, t)


@pytest.mark.parametrize("mode", ["detect_only", "remove"])
def test_smart_text_sensitive_modes_parity(mode):
    rng = np.random.default_rng(29)
    j, t = fit_both("ops.vectorizers", "SmartTextVectorizer",
                    {"sensitive_feature_mode": mode}, ["x"],
                    {"x": ("Text", _names(rng, 120))})
    assert_same_stage(j, t)


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

def _corpus(seed=0, n=300, V=60, k=4, length=40):
    rng = np.random.default_rng(seed)
    topics = rng.dirichlet(np.full(V, 0.1), size=k)
    theta = rng.dirichlet(np.full(k, 0.3), size=n)
    return np.stack([rng.multinomial(length, theta[i] @ topics)
                     for i in range(n)]).astype(np.float32)


def _jax_fit(counts, k, em_iters=30, e_iters=20):
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu.ops import lda as J
    fit = jax.jit(J.fit_lda, static_argnums=(1, 4, 5, 6))
    lam = np.asarray(fit(jnp.asarray(counts), k, 0.1, 0.01, em_iters,
                         e_iters, 0))
    topics = np.asarray(jax.jit(J.infer_topics)(jnp.asarray(counts),
                                                jnp.asarray(lam), 0.1))
    return lam, topics


def _close_lam(got, want):
    np.testing.assert_allclose(got, want, rtol=LAM_RTOL,
                               atol=LAM_ATOL_SCALE * np.abs(want).max())


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8)])
def test_fit_lda_matches_jax_given_its_draws(seed, k):
    from transmogrifai_tpu_torch.ops import lda as P
    counts = _corpus(seed, k=k)
    jlam, jtopics = _jax_fit(counts, k)
    lam = P.fit_lda(torch.from_numpy(counts), k, 0.1, 0.01, 30, 20, 0,
                    lam0=jax_lam0(k, counts.shape[1]))
    _close_lam(lam.numpy(), jlam)
    topics = P.infer_topics(torch.from_numpy(counts), torch.from_numpy(jlam),
                            0.1).numpy()
    np.testing.assert_allclose(topics, jtopics, rtol=TOPIC_RTOL,
                               atol=TOPIC_ATOL)


@pytest.mark.parametrize("fault", ["one_e_step_less", "one_em_step_less",
                                   "digamma_as_log"])
def test_planted_lda_fault_fails_the_tolerance(fault, monkeypatch):
    from transmogrifai_tpu_torch.ops import lda as P
    counts = _corpus(0)
    k, V = 4, counts.shape[1]
    jlam, _ = _jax_fit(counts, k)
    em, e = 30, 20
    if fault == "one_e_step_less":
        e = 19
    elif fault == "one_em_step_less":
        em = 29
    else:
        monkeypatch.setattr(P.torch.special, "digamma", torch.log)
    lam = P.fit_lda(torch.from_numpy(counts), k, 0.1, 0.01, em, e, 0,
                    lam0=jax_lam0(k, V)).numpy()
    with pytest.raises(AssertionError):
        _close_lam(lam, jlam)


def test_lam0_forms_and_own_draws():
    from transmogrifai_tpu_torch.ops import lda as P
    counts = torch.from_numpy(_corpus(2, n=50, V=20, k=3))
    a = P.fit_lda(counts, 3, em_iters=3, lam0=jax_lam0(3, 20))
    b = P.fit_lda(counts, 3, em_iters=3, lam0=lambda k, V: jax_lam0(k, V))
    c = P.fit_lda(counts, 3, em_iters=3,
                  lam0=torch.from_numpy(jax_lam0(3, 20)))
    assert torch.equal(a, b) and torch.equal(a, c)
    own = P.fit_lda(counts, 3, em_iters=3, seed=5)
    assert torch.equal(own, P.fit_lda(counts, 3, em_iters=3, seed=5))
    assert torch.equal(P.fit_lda(counts, 3, em_iters=0, seed=5),
                       P.initial_lambda(3, 20, 5))
    with pytest.raises(ValueError, match="lam0 has shape"):
        P.fit_lda(counts, 3, lam0=jax_lam0(3, 19))


def _two_topic(n=60):
    from test_text_completeness import _two_topic_corpus
    return _two_topic_corpus(np.random.default_rng(0), n)


def test_oplda_stage_matches_jax_given_its_draws():
    docs = _two_topic(80)
    kw = {"k": 3, "vocab_size": 16, "em_iters": 12}
    j, t = fit_both("ops.lda", "OpLDA", kw, ["x"], {"x": ("TextArea", docs)},
                    port_extra={"device": "cpu",
                                "lam0": lambda k, V: jax_lam0(k, V)})
    (jm, jout, jds), (tm, tout, tds) = j, t
    assert tm.params == jm.params
    assert tm.stage_params_json() == jm.stage_params_json()
    _close_lam(tm.lam.numpy(), jm.lam)
    name = jm.output.name
    np.testing.assert_allclose(tout.column(name), jout.column(name),
                               rtol=TOPIC_RTOL, atol=TOPIC_ATOL)
    assert tout.manifest(name).to_json() == jout.manifest(name).to_json()


def test_oplda_own_draws_separate_two_topics():
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops import OpLDA
    from transmogrifai_tpu_torch.testkit import TestFeatureBuilder
    docs = _two_topic(60)
    ds, f = TestFeatureBuilder.single("txt", ft.TextArea, docs)
    est = OpLDA(k=2, vocab_size=64, em_iters=40, device="cpu").set_input(f)
    model, out = est.fit_transform(ds)
    dom = out.column(model.output.name).argmax(axis=1)
    assert (dom[0::2] == dom[0]).mean() > 0.9
    assert (dom[1::2] == dom[1]).mean() > 0.9
    assert dom[0] != dom[1]


def test_lda_model_loads_across_packages():
    from transmogrifai_tpu.stages import persistence as JP
    from transmogrifai_tpu_torch.stages import persistence as PP
    docs = _two_topic(30)
    kw = {"k": 2, "vocab_size": 12, "em_iters": 5}
    j, t = fit_both("ops.lda", "OpLDA", kw, ["x"], {"x": ("TextArea", docs)},
                    port_extra={"device": "cpu"})
    (jm, _, jds), (tm, _, tds) = j, t
    for src, dst_p, ds in ((jm, PP, tds), (tm, JP, jds)):
        doc = (JP if src is jm else PP).stage_to_json(src)
        loaded = dst_p.stage_from_json(doc)
        want = src.transform(ds).column(src.output.name)
        got = loaded.transform(ds).column(loaded.output.name)
        np.testing.assert_allclose(got, want, rtol=TOPIC_RTOL,
                                   atol=TOPIC_ATOL)
        assert loaded.params["vocab"] == src.params["vocab"]


def test_oplda_on_the_cpu_needs_no_card_but_none_asks_for_one(monkeypatch):
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops import OpLDA
    from transmogrifai_tpu_torch.testkit import TestFeatureBuilder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, f = TestFeatureBuilder.single("txt", ft.TextArea, _two_topic(10))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OpLDA(k=2, vocab_size=8, em_iters=2).set_input(f).fit(ds)


MIRRORS = {f: load_mirror(f) for f in ("test_text_completeness.py",
                                       "test_analyzers.py",
                                       "test_ner_tagger.py")}


@pytest.mark.parametrize("name,kwargs",
                         mirror_cases(MIRRORS["test_text_completeness.py"]))
def test_text_completeness_case_on_the_port(name, kwargs, request,
                                            port_on_cpu):
    run_mirror_case(MIRRORS["test_text_completeness.py"], name, kwargs,
                    request)


@pytest.mark.parametrize("name,kwargs",
                         mirror_cases(MIRRORS["test_analyzers.py"]))
def test_analyzers_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRRORS["test_analyzers.py"], name, kwargs, request)


@pytest.mark.parametrize("name,kwargs",
                         mirror_cases(MIRRORS["test_ner_tagger.py"]))
def test_ner_tagger_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRRORS["test_ner_tagger.py"], name, kwargs, request)
