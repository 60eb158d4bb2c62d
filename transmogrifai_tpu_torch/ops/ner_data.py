"""Embedded CoNLL-style training corpus for the perceptron NER tagger.

Reference: NameEntityRecognizer.scala wraps OpenNLP's TRAINED token name
finders; OpenNLP ships binary models learned from annotated corpora. No
such corpus can be fetched here (zero egress), so the tagger trains on a
deterministic template-expanded corpus built from slot lexicons: the
generator below yields (tokens, BIO tags) sentences covering the
honorific/full-name/org-suffix/location contexts the reference models
handle. Held-out evaluation uses DISJOINT filler lexicons (unseen names,
unseen org cores) so the measured F1 reflects shape/context
generalization, not memorization (tests/test_ner_tagger.py).

The port's copy of ``transmogrifai_tpu/ops/ner_data.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

import random
from typing import List, Tuple

# -- slot lexicons (train split) -------------------------------------------

TRAIN_FIRST = [
    "James", "Mary", "Robert", "Patricia", "John", "Jennifer", "Michael",
    "Linda", "David", "Elena", "William", "Barbara", "Richard", "Susan",
    "Joseph", "Jessica", "Thomas", "Sarah", "Carlos", "Karen", "Pierre",
    "Nancy", "Ahmed", "Lisa", "Yuki", "Betty", "Omar", "Helen", "Ivan",
    "Sandra", "Miguel", "Donna", "Chen", "Carol", "Rajesh", "Ruth",
    "Kofi", "Sharon", "Lars", "Michelle",
]
TRAIN_LAST = [
    "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia", "Miller",
    "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez", "Gonzalez",
    "Wilson", "Anderson", "Taylor", "Moore", "Jackson", "Martin", "Lee",
    "Perez", "Thompson", "White", "Harris", "Sanchez", "Clark",
    "Ramirez", "Lewis", "Robinson", "Walker", "Young", "Allen", "King",
    "Wright", "Scott", "Torres", "Nguyen", "Hill", "Flores", "Green",
    # location-homograph surnames: teaches gaz=True to yield to person
    # context ("Mr. London said") instead of forcing Location
    "London", "Paris", "Jordan", "Washington",
]
TRAIN_ORG_CORE = [
    "Acme", "Globex", "Initech", "Umbrella", "Stark", "Wayne", "Cyberdyne",
    "Tyrell", "Wonka", "Oscorp", "Monarch", "Zenith", "Apex", "Pinnacle",
    "Summit", "Horizon", "Frontier", "Atlas", "Titan", "Nova", "Quantum",
    "Stellar", "Meridian", "Cascade", "Redwood", "Ironwood", "Bluepeak",
    "Silverline", "Northstar", "Eastgate",
]
ORG_SUFFIXES = [
    "Inc", "Corp", "Ltd", "LLC", "Group", "Holdings", "Bank",
    "University", "Institute", "Foundation", "Association", "Ministry",
    "Agency", "Company", "Industries", "Systems", "Capital", "Partners",
    "Technologies", "Labs", "Ventures", "Networks", "Aviation", "Energy",
    "Airlines", "Pharmaceuticals", "Media", "PLC", "Logistics",
]
#: role titles precede a person WITHOUT being part of the name (the
#: natural-text error class: "Mayor Celeste Fontaine" -> Mayor is O)
ROLE_TITLES = [
    ["Mayor"], ["President"], ["Senator"], ["Governor"], ["Judge"],
    ["Prime", "Minister"], ["Chief", "Executive"], ["Vice", "President"],
]
TRAIN_LOC = [
    "London", "Paris", "Berlin", "Tokyo", "Madrid", "Rome", "Moscow",
    "Beijing", "Delhi", "Sydney", "Toronto", "Chicago", "Boston",
    "Amsterdam", "Dublin", "Vienna", "Prague", "Warsaw", "Cairo",
    "Nairobi", "Lagos", "Istanbul", "Seoul", "Bangkok", "Jakarta",
    "France", "Germany", "Japan", "Brazil", "Canada", "Kenya", "India",
    "Spain", "Poland", "Egypt", "Norway", "Chile", "Vietnam", "Ghana",
    "Finland",
]
HONORIFICS = ["Mr.", "Mrs.", "Ms.", "Dr.", "Prof.", "Sir", "Capt."]

# -- held-out lexicons (disjoint from every train list) --------------------

HELD_FIRST = ["Amina", "Bjorn", "Chiara", "Dmitri", "Esperanza", "Farid",
              "Greta", "Hiroshi", "Ingrid", "Joaquin", "Katarina",
              "Leopold", "Mariana", "Nikolai", "Ophelia", "Priya"]
HELD_LAST = ["Abernathy", "Bellweather", "Castellanos", "Drummond",
             "Eriksson", "Fitzwilliam", "Grimaldi", "Hawthorne",
             "Iwamoto", "Jankowski", "Kovalenko", "Lindqvist",
             "Montgomery", "Nakamura", "Okonkwo", "Petrov"]
HELD_ORG_CORE = ["Vertex", "Obsidian", "Lighthouse", "Crestfall",
                 "Windmere", "Falconer", "Greystone", "Halcyon",
                 "Ironclad", "Juniper"]
HELD_LOC = ["Lisbon", "Helsinki", "Brussels", "Santiago", "Auckland",
            "Geneva", "Kyoto", "Casablanca", "Bogota", "Riga",
            "Portugal", "Belgium", "Iceland", "Morocco", "Peru"]

# -- templates -------------------------------------------------------------
# slots: P=person, O=organization, L=location, H=honorific (ties to the
# following person). Non-slot tokens are O-tagged context words chosen to
# cover the verbs/prepositions around names the reference models rely on.

TEMPLATES: List[List[str]] = [
    ["P", "works", "at", "O", "in", "L", "."],
    ["H", "P", "visited", "L", "last", "week", "."],
    ["O", "announced", "a", "partnership", "with", "O", "."],
    ["P", "and", "P", "met", "in", "L", "on", "Monday", "."],
    ["the", "O", "board", "appointed", "P", "as", "chief", "executive",
     "."],
    ["P", "flew", "from", "L", "to", "L", "yesterday", "."],
    ["analysts", "at", "O", "expect", "growth", "in", "L", "."],
    ["H", "P", "joined", "O", "as", "director", "."],
    ["P", "was", "born", "in", "L", "and", "raised", "in", "L", "."],
    ["shares", "of", "O", "fell", "after", "the", "announcement", "."],
    ["P", "said", "the", "deal", "with", "O", "would", "close", "soon",
     "."],
    ["the", "mayor", "of", "L", "thanked", "P", "for", "the", "donation",
     "."],
    ["O", "opened", "a", "new", "office", "in", "L", "."],
    ["according", "to", "P", ",", "the", "merger", "is", "complete", "."],
    ["H", "P", "teaches", "at", "O", "in", "L", "."],
    ["P", "succeeded", "P", "as", "head", "of", "O", "."],
    ["residents", "of", "L", "protested", "outside", "O", "offices", "."],
    ["P", "signed", "the", "contract", "with", "O", "on", "Friday", "."],
    ["the", "delegation", "from", "L", "arrived", "in", "L", "."],
    ["O", "hired", "P", "to", "lead", "its", "L", "branch", "."],
    ["P", "spoke", "with", "P", "about", "the", "project", "."],
    ["she", "traveled", "with", "P", "to", "L", "."],
    ["P", "flew", "to", "L", "with", "P", "yesterday", "."],
    ["a", "meeting", "between", "P", "and", "O", "ended", "early", "."],
    # sentence-initial capitalized common words / imperatives / titles —
    # natural text starts sentences with capitals that are NOT entities
    # (the dominant error class on the natural-text eval before these)
    ["the", "merger", "between", "O", "and", "O", "was", "announced",
     "."],
    ["the", "court", "ruled", "against", "O", "on", "appeal", "."],
    ["please", "forward", "the", "invoice", "to", "P", "before",
     "Friday", "."],
    ["contact", "P", "in", "our", "L", "office", "."],
    ["earnings", "at", "O", "beat", "expectations", "."],
    ["shares", "of", "O", "fell", "4", "percent", "in", "L", "trading",
     "."],
    ["her", "flight", "from", "L", "was", "delayed", "by", "two",
     "hours", "."],
    ["flooding", "closed", "roads", "across", "L", "on", "Monday", "."],
    ["we", "met", "P", "and", "her", "colleagues", "in", "L", "."],
    ["T", "P", "arrived", "in", "L", "for", "talks", "."],
    ["T", "P", "will", "visit", "L", "and", "L", "."],
    ["T", "P", "declined", "to", "comment", "on", "the", "deal", "."],
    ["the", "conference", "moves", "from", "L", "to", "L", "next",
     "year", "."],
    # honorific + bare surname ("Mr. London said"): the surname slot S
    # draws from TRAIN_LAST, incl. the location homographs, so person
    # context beats the gazetteer feature
    ["H", "S", "said", "the", "report", "was", "late", "."],
    ["H", "S", "joined", "O", "as", "an", "adviser", "."],
    ["H", "S", "will", "chair", "the", "committee", "in", "L", "."],
    ["according", "to", "H", "S", ",", "sales", "doubled", "."],
]


def _fill(template, rng, first, last, org_core, loc):
    toks: List[str] = []
    tags: List[str] = []
    i = 0
    while i < len(template):
        slot = template[i]
        if slot == "P":
            toks += [rng.choice(first), rng.choice(last)]
            tags += ["B-PER", "I-PER"]
        elif slot == "O":
            core = rng.choice(org_core)
            suf = rng.choice(ORG_SUFFIXES)
            toks += [core, suf]
            tags += ["B-ORG", "I-ORG"]
            if rng.random() < 0.2:      # "Dunmore Holdings Ltd" shapes
                toks.append(rng.choice(["Ltd", "Inc", "PLC"]))
                tags.append("I-ORG")
        elif slot == "L":
            toks.append(rng.choice(loc))
            tags.append("B-LOC")
        elif slot == "H":
            toks.append(rng.choice(HONORIFICS))
            tags.append("O")
        elif slot == "S":
            toks.append(rng.choice(last))
            tags.append("B-PER")
        elif slot == "T":
            title = rng.choice(ROLE_TITLES)
            toks += title
            tags += ["O"] * len(title)
        else:
            toks.append(slot)
            tags.append("O")
        i += 1
    # real sentences start capitalized whether or not the first token is
    # an entity — train the same convention so sentence-initial "The"/
    # "Shares"/"Please" stop reading as names
    if toks and toks[0][0].islower():
        toks[0] = toks[0][0].upper() + toks[0][1:]
    return toks, tags


def training_sentences(n: int = 400, seed: int = 13
                       ) -> List[Tuple[List[str], List[str]]]:
    """Deterministic template expansion over the TRAIN lexicons."""
    rng = random.Random(seed)
    out = []
    for k in range(n):
        t = TEMPLATES[k % len(TEMPLATES)]
        out.append(_fill(t, rng, TRAIN_FIRST, TRAIN_LAST, TRAIN_ORG_CORE,
                         TRAIN_LOC))
    return out


def heldout_sentences(n: int = 120, seed: int = 97
                      ) -> List[Tuple[List[str], List[str]]]:
    """Held-out split: same sentence shapes, DISJOINT fillers — every
    person/org surface form is unseen; half the locations are unseen
    (the rest exercise the gazetteer feature)."""
    rng = random.Random(seed)
    out = []
    for k in range(n):
        t = TEMPLATES[(k * 7 + 3) % len(TEMPLATES)]
        loc = HELD_LOC if k % 2 == 0 else TRAIN_LOC
        out.append(_fill(t, rng, HELD_FIRST, HELD_LAST, HELD_ORG_CORE,
                         loc))
    return out
