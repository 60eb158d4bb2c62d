"""Language-aware text analysis: stemming + stopwords.

Reference: core/.../stages/impl/feature/TextTokenizer.scala drives
Lucene per-language analyzers (tokenize -> lowercase -> stop filter ->
stemmer), picking the analyzer from detected language. The TPU build
keeps analysis host-side (it feeds hashing/vocab vectorizers) and
implements the same pipeline natively in Python: the classic Porter
stemming algorithm for English plus "light" suffix stemmers for the
other supported languages (mirroring Lucene's *LightStemmer family),
and embedded stopword sets. Deterministic, no JVM, no external data.

The port's copy of ``transmogrifai_tpu/ops/analyzers.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional

# ---------------------------------------------------------------------------
# Porter stemmer (Porter, 1980 — "An algorithm for suffix stripping")
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences: [C](VC)^m[V]."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        if _is_cons(stem, i):
            if prev_vowel:
                m += 1
            prev_vowel = False
        else:
            prev_vowel = True
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return (len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1))


def _ends_cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    return (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2)
            and _is_cons(w, len(w) - 1) and w[-1] not in "wxy")


def porter_stem(w: str) -> str:
    """Porter's algorithm, steps 1a-5b. Input should be lowercase."""
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    for suf, repl in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                      ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                      ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                      ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                      ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                      ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                      ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 0:
                w = stem + repl
            break

    # Step 3
    for suf, repl in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                      ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                      ("ness", "")):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 0:
                w = stem + repl
            break

    # Step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    continue
                w = stem
            break

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# Light stemmers (mirror Lucene's {Spanish,French,German,Italian,
# Portuguese}LightStemmer: strip plural/gender/verbal suffixes, no tables)
# ---------------------------------------------------------------------------

def _light_stem_es(w: str) -> str:
    for suf in ("amientos", "imientos", "amiento", "imiento", "aciones",
                "uciones", "adoras", "adores", "ancias", "acion", "adora",
                "ación", "antes", "ancia", "mente", "idades", "idad",
                "ables", "ibles", "istas", "able", "ible", "ista", "osos",
                "osas", "oso", "osa", "ces", "es", "os", "as", "s", "a",
                "o", "e"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_fr(w: str) -> str:
    for suf in ("issements", "issement", "atrices", "ateurs", "ations",
                "atrice", "ateur", "ation", "euses", "ments", "ement",
                "euse", "ités", "ment", "eurs", "ités", "ité", "eur",
                "ies", "ion", "ie", "es", "s", "e"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_de(w: str) -> str:
    for suf in ("heiten", "keiten", "ungen", "heit", "keit", "ung", "isch",
                "en", "er", "es", "em", "e", "n", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 4:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_it(w: str) -> str:
    for suf in ("azioni", "azione", "amenti", "imenti", "amento", "imento",
                "mente", "atori", "atore", "anza", "anze", "ici", "ice",
                "iche", "ichi", "i", "e", "a", "o"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_pt(w: str) -> str:
    for suf in ("amentos", "imentos", "amento", "imento", "adoras",
                "adores", "aço~es", "ações", "ancias", "ância", "mente",
                "idades", "idade", "ista", "avel", "ível", "oso", "osa",
                "es", "os", "as", "s", "a", "o", "e"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_nl(w: str) -> str:
    if w.endswith("heden") and len(w) >= 8:
        return w[:-5] + "heid"
    for suf in ("ingen", "eren", "ende", "sten", "tjes", "ers", "en",
                "er", "es", "je", "e", "s"):
        min_stem = 4 if len(suf) == 1 else 3
        if w.endswith(suf) and len(w) - len(suf) >= min_stem:
            w = w[: len(w) - len(suf)]
            break
    # final-obstruent devoicing (huizen->huiz->huis, brieven->briev->brief)
    if w.endswith("z"):
        return w[:-1] + "s"
    if w.endswith("v"):
        return w[:-1] + "f"
    return w


def _light_stem_sv(w: str) -> str:
    for suf in ("heterna", "heten", "heter", "arnas", "ernas", "ornas",
                "andet", "arna", "erna", "orna", "ande", "aste", "aren",
                "ades", "ade", "are", "ens", "het", "ast", "ad", "en",
                "ar", "er", "or", "as", "es", "at", "a", "e", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_da(w: str) -> str:
    """Danish/Norwegian shared light stemmer (the Scandinavian suffix
    systems overlap heavily at light-stemming depth)."""
    for suf in ("erendes", "erende", "hedens", "ernes", "erens", "heden",
                "elser", "elsen", "enes", "eres", "erne", "eren", "heds",
                "ede", "ene", "ens", "ere", "ers", "ets", "en", "er",
                "es", "et", "e", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_fi(w: str) -> str:
    """Finnish light stemmer: strip the most frequent case/possessive
    endings (full Finnish morphology needs Snowball-depth rules; this is
    the Lucene FinnishLightStemmer coverage class)."""
    for suf in ("issa", "issä", "ista", "istä", "iksi", "ihin", "illa",
                "illä", "ilta", "iltä", "ille", "ssa", "ssä", "sta",
                "stä", "lla", "llä", "lta", "ltä", "lle", "ksi", "ina",
                "inä", "iin", "an", "än", "en", "in", "at", "ät", "et",
                "t", "a", "ä", "n"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def _light_stem_ru(w: str) -> str:
    """Russian light stemmer: adjective/noun/verb ending strip
    (RussianLightStemmer's coverage class, Cyrillic input)."""
    for suf in ("иями", "ями", "ами", "иях", "иям", "ием", "ией", "ого",
                "ому", "ыми", "ими", "его", "ему", "ешь", "ются", "ется",
                "ать", "ять", "ала", "яла", "или", "ает", "яет", "ают",
                "яют", "ая", "яя", "ую", "юю", "ой", "ей", "ом", "ем",
                "ым", "им", "ые", "ие", "ых", "их", "ов", "ев", "ий",
                "ый", "ам", "ям", "ах", "ях", "ия", "ию", "ии", "ет",
                "ут", "ют", "ит", "ат", "ят", "а", "я", "о", "е", "ы",
                "и", "ь", "у", "ю"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


_STEMMERS = {"en": porter_stem, "es": _light_stem_es, "fr": _light_stem_fr,
             "de": _light_stem_de, "it": _light_stem_it, "pt": _light_stem_pt,
             "nl": _light_stem_nl, "sv": _light_stem_sv, "da": _light_stem_da,
             "no": _light_stem_da, "fi": _light_stem_fi,
             "ru": _light_stem_ru}


# ---------------------------------------------------------------------------
# Stopwords (Lucene's default sets, trimmed to the high-frequency cores)
# ---------------------------------------------------------------------------

STOPWORDS: Dict[str, FrozenSet[str]] = {
    "en": frozenset("""a an and are as at be but by for if in into is it no
        not of on or such that the their then there these they this to was
        will with i you he she we his her its our your them me him us am
        been being have has had do does did would should could than so
        what which who whom when where why how all any both each few more
        most other some only own same too very can just don now were from
        out up about over under again further once here during after
        before above below between through against""".split()),
    "es": frozenset("""de la que el en y a los del se las por un para con
        no una su al lo como mas pero sus le ya o este si porque esta entre
        es son era eran fue ser estar tiene tienen
        cuando muy sin sobre tambien me hasta hay donde quien desde todo
        nos durante todos uno les ni contra otros ese eso ante ellos e
        esto mi antes algunos que unos yo otro otras otra el tanto esa
        estos mucho quienes nada muchos cual poco ella estar estas algunas
        algo nosotros""".split()),
    "fr": frozenset("""au aux avec ce ces dans de des du elle en et eux il
        je la le leur lui ma mais me meme mes moi mon ne nos notre nous on
        ou par pas pour qu que qui sa se ses son sur ta te tes toi ton tu
        un une vos votre vous c d j l m n s t y est ete etee etees etes
        etant suis es sont serai seras sera serons serez seront""".split()),
    "de": frozenset("""aber alle allem allen aller alles als also am an
        ander andere anderem anderen anderer anderes auch auf aus bei bin
        bis bist da damit dann der den des dem die das dass du er sie es
        ein eine einem einen einer eines fur hatte hatten hier hin ich
        ihr ihre im in ist ja kann kein mein mit nach nicht noch nun nur
        ob oder ohne sehr sein seine sind so uber um und uns unter vom von
        vor war waren was weiter wenn werde werden wie wieder will wir
        wird zu zum zur""".split()),
    "it": frozenset("""ad al allo ai agli all agl alla alle con col coi da
        dal dallo dai dagli dall dagl dalla dalle di del dello dei degli
        dell degl della delle in nel nello nei negli nell negl nella nelle
        su sul sullo sui sugli sull sugl sulla sulle per tra contro io tu
        lui lei noi voi loro mio mia miei mie tuo tua tuoi tue suo sua
        suoi sue nostro nostra nostri nostre che e ed se perche anche come
        dov dove chi cui non piu quale quanto quanti quanta quante quello
        questo si tutto tutti a c l un uno una ma ho ha""".split()),
    "pt": frozenset("""de a o que e do da em um para com nao uma os no se
        na por mais as dos como mas ao ele das a seu sua ou quando muito
        nos ja eu tambem so pelo pela ate isso ela entre depois sem mesmo
        aos seus quem nas me esse eles voce essa num nem suas meu as minha
        numa pelos elas qual nos lhe deles essas esses pelas este dele tu
        te voces vos lhes meus minhas teu tua teus tuas nosso nossa nossos
        nossas""".split()),
    "nl": frozenset("""de en van ik te dat die in een hij het niet zijn is
        was op aan met als voor had er maar om hem dan zou of wat mijn men
        dit zo door over ze zich bij ook tot je mij uit der daar haar naar
        heb hoe heeft hebben deze u want nog zal me zij nu ge geen omdat
        iets worden toch al waren veel meer doen toen moet ben zonder kan
        hun dus alles onder ja eens hier wie werd altijd doch wordt
        wezen kunnen ons zelf tegen na reeds wil kon niets uw iemand
        geweest andere""".split()),
    "sv": frozenset("""och det att i en jag hon som han pa den med var sig
        for sa till ar men ett om hade de av icke mig du henne da sin nu
        har inte hans honom skulle hennes dar min man ej vid kunde nagot
        fran ut nar efter upp vi dem vara vad over an dig kan sina hit
        aven at oss under ni mot dessa dessa vilka era alla mycket
        bara blir bli blev varit""".split()),
    "da": frozenset("""og i jeg det at en den til er som pa de med han af
        for ikke der var mig sig men et har om vi min havde ham hun nu
        over da fra du ud sin dem os op man hans hvor eller hvad skal
        selv her alle vil blev kunne ind nar vaere dog noget ville jo
        deres efter ned skulle denne end dette mit ogsa under have dig
        anden hende mine alt meget sit sine vor mod disse hvis din nogle
        hos blive mange ad bliver hendes vaeret thi jer sadan""".split()),
    "fi": frozenset("""olla olen olet on olemme olette ovat ole oli ja
        etta jos koska kun niin kuin mutta vaan sina mina han me te he se
        ne tama nama tuo nuo joka jotka mika mitka siis myos viela ei eika
        han kanssa mukaan ilman kautta paalla alla yli ali ennen jalkeen
        vastaan kohti luona takia vuoksi sita tata niita naita sen taman
        hyvin nyt sitten taalla siella""".split()),
    "ru": frozenset("""и в во не что он на я с со как а то все она так его
        но да ты к у же вы за бы по только ее мне было вот от меня еще нет
        о из ему теперь когда даже ну вдруг ли если уже или ни быть был
        него до вас нибудь опять уж вам ведь там потом себя ничего ей
        может они тут где есть надо ней для мы тебя их чем была сам чтоб
        без будто чего раз тоже себе под будет ж тогда кто этот того
        потому этого какой совсем ним здесь этом один почти мой тем чтобы
        нее сейчас были куда зачем всех никогда можно при об хотя""".split()),
}


import unicodedata as _unicodedata


_NO_DECOMP = str.maketrans({
    # letters with NO canonical decomposition — NFKD+ascii-ignore would
    # DROP them ('være' -> 'vre'); transliterate first so the folded
    # token matches the stored set ('vaere')
    "æ": "ae", "Æ": "AE", "ø": "o", "Ø": "O", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ð": "d", "Ð": "D", "þ": "th", "Þ": "TH", "ı": "i",
    "đ": "d", "Đ": "D", "ł": "l", "Ł": "L"})


def _fold_accents(s: str) -> str:
    """Accent strip for stopword membership ('más' -> 'mas', 'være' ->
    'vaere'). The stopword sets are stored folded; tokens keep their
    accents for the stemmers, only the membership test folds."""
    return _unicodedata.normalize("NFKD", s.translate(_NO_DECOMP)).encode(
        "ascii", "ignore").decode("ascii")


def analyze_tokens(tokens: List[str], lang: str = "en",
                   remove_stopwords: bool = True,
                   stem: bool = True) -> List[str]:
    """Lucene-analyzer-equivalent filter chain over pre-split tokens."""
    stops = STOPWORDS.get(lang, frozenset()) if remove_stopwords else frozenset()
    stemmer = _STEMMERS.get(lang) if stem else None
    out = []
    for t in tokens:
        # ASCII tokens fold to themselves — only non-ASCII pays the NFKD
        if t in stops or (stops and not t.isascii()
                          and _fold_accents(t) in stops):
            continue
        out.append(stemmer(t) if stemmer else t)
    return out
