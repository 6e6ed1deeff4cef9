"""Lightweight in-repo POS tagger for content-word MLM masking.

The reference masks object/verb phrases picked by spaCy + SceneGraphParser
(mmaction/datasets/pipelines/loading.py:226-288,340-390): NOUN/PROPN words
plus verb-phrase spans matching the spaCy Matcher pattern
``VERB? ADV* AUX* VERB+``. spaCy is not available in this image, so this
module provides the same word->coarse-POS signal with a closed-class
lexicon + morphology rules — no model download, deterministic, and fast
enough to run per caption on the host loader path.

Tagset (coarse, spaCy-compatible subset): NOUN PROPN VERB AUX ADV ADJ DET
ADP PRON CONJ NUM PART INTJ X.

Accuracy target is the masking decision, not treebank parity: captions are
short, present-tense, object-heavy ("a man is playing guitar on the
street"), and the tagger must (a) never promote stop words to content
words and (b) catch regular verb morphology. tests/test_data.py pins the
selections on sample captions against the reference's picks.

Port of ``clover_tpu/data/pos_tagger.py``: a copy, held against it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import re
from typing import List, Sequence

# --------------------------------------------------------------- lexicons

# Closed-class words: the reference's spaCy tags these DET/ADP/PRON/... and
# they are never selected for masking.
_DET = {"a", "an", "the", "this", "that", "these", "those", "some", "any",
        "no", "every", "each", "either", "neither", "both", "all", "such",
        "another", "other", "what", "which", "whose"}
_ADP = {"in", "on", "at", "by", "for", "with", "about", "against", "between",
        "into", "through", "during", "before", "after", "above", "below",
        "to", "from", "up", "down", "of", "off", "over", "under", "again",
        "near", "behind", "beside", "beyond", "inside", "outside", "onto",
        "upon", "within", "without", "along", "across", "around", "toward",
        "towards", "past", "via", "amid", "among", "despite", "except",
        "per", "than", "until", "unless", "since"}
_PRON = {"i", "me", "my", "mine", "myself", "we", "us", "our", "ours",
         "ourselves", "you", "your", "yours", "yourself", "yourselves",
         "he", "him", "his", "himself", "she", "her", "hers", "herself",
         "it", "its", "itself", "they", "them", "their", "theirs",
         "themselves", "who", "whom", "someone", "something", "anyone",
         "anything", "everyone", "everything", "nobody", "nothing", "one"}
_CONJ = {"and", "but", "or", "nor", "so", "yet", "because", "although",
         "though", "while", "whereas", "if", "when", "where", "why", "how",
         "as", "once", "whether"}
_AUX = {"is", "am", "are", "was", "were", "be", "been", "being",
        "do", "does", "did", "have", "has", "had", "having",
        "will", "would", "shall", "should", "may", "might", "must", "can",
        "could", "cannot"}
_PART = {"not", "n't", "'s", "'re", "'ve", "'ll", "'d", "'m"}
_ADV = {"very", "really", "quite", "too", "also", "just", "only", "even",
        "still", "already", "always", "never", "often", "sometimes",
        "usually", "rarely", "here", "there", "now", "then", "today",
        "soon", "later", "quickly", "slowly", "carefully", "together",
        "away", "back", "out", "well", "almost", "nearly", "perhaps",
        "maybe", "again", "twice", "once"}
_INTJ = {"oh", "wow", "hey", "yes", "yeah", "no", "please", "thanks", "ok",
         "okay"}
_NUM = {"zero", "two", "three", "four", "five", "six", "seven", "eight",
        "nine", "ten", "eleven", "twelve", "twenty", "thirty", "forty",
        "fifty", "hundred", "thousand", "million", "dozen", "half"}

# Common adjectives (reference never selects ADJ — its attr list stays
# empty, loading.py:256-257 — so these must not be tagged NOUN).
_ADJ = {"big", "small", "large", "little", "tall", "short", "long", "high",
        "low", "old", "young", "new", "good", "bad", "great", "nice",
        "beautiful", "pretty", "ugly", "happy", "sad", "angry", "fast",
        "slow", "hot", "cold", "warm", "cool", "red", "blue", "green",
        "yellow", "black", "white", "brown", "orange", "purple", "pink",
        "gray", "grey", "dark", "light", "bright", "heavy", "soft", "hard",
        "easy", "difficult", "full", "empty", "open", "closed", "wet",
        "dry", "clean", "dirty", "busy", "quiet", "loud", "strong", "weak",
        "rich", "poor", "right", "wrong", "same", "different", "several",
        "many", "few", "much", "more", "most", "less", "least", "first",
        "second", "third", "last", "next", "own", "main", "whole", "wooden",
        "plastic", "metal", "golden", "tiny", "huge", "giant", "round"}

# Common base verbs of caption language; inflections derived by rule.
_VERB_BASE = {
    "go", "get", "make", "take", "come", "see", "look", "watch", "use",
    "find", "give", "tell", "say", "speak", "talk", "work", "call", "try",
    "ask", "need", "feel", "become", "leave", "put", "mean", "keep", "let",
    "begin", "start", "stop", "show", "hear", "play", "run", "move",
    "walk", "jump", "sit", "stand", "lie", "turn", "bring", "happen",
    "write", "read", "eat", "drink", "cook", "bake", "cut", "chop", "mix",
    "stir", "pour", "add", "wash", "clean", "wipe", "drive", "ride",
    "fly", "swim", "climb", "fall", "throw", "catch", "kick", "hit",
    "push", "pull", "lift", "carry", "hold", "drop", "pick", "place",
    "open", "close", "break", "build", "fix", "paint", "draw", "sing",
    "dance", "laugh", "smile", "cry", "sleep", "wake", "dress", "wear",
    "buy", "sell", "pay", "win", "lose", "fight", "race", "chase",
    "follow", "meet", "join", "help", "teach", "learn", "train",
    "practice", "perform", "demonstrate", "explain", "describe", "point",
    "wave", "shake", "nod", "touch", "grab", "squeeze", "press", "slice",
    "peel", "spread", "wrap", "fold", "hang", "attach", "remove", "insert",
    "fill", "empty", "spray", "sprinkle", "dip", "flip", "roll", "spin",
    "bounce", "slide", "swing", "stretch", "bend", "kneel", "crawl",
    "hop", "skip", "march", "jog", "sprint", "dive", "surf", "ski",
    "skate", "shoot", "score", "pass", "serve", "bat", "pitch", "juggle",
    "balance", "exercise", "stand", "travel", "visit", "arrive", "enter",
    "exit", "cross", "pet", "feed", "bark", "play",
}

_CLOSED = {}
for _words, _tag in ((_DET, "DET"), (_ADP, "ADP"), (_PRON, "PRON"),
                     (_CONJ, "CONJ"), (_AUX, "AUX"), (_PART, "PART"),
                     (_ADV, "ADV"), (_INTJ, "INTJ"), (_NUM, "NUM"),
                     (_ADJ, "ADJ")):
    for _w in _words:
        _CLOSED.setdefault(_w, _tag)

_VERB_FORMS = set(_VERB_BASE)
for _v in _VERB_BASE:
    _VERB_FORMS.add(_v + "s" if not _v.endswith(("s", "sh", "ch", "x", "o"))
                    else _v + "es")
    if _v.endswith("e"):
        _VERB_FORMS.add(_v[:-1] + "ing")
        _VERB_FORMS.add(_v + "d")
    elif _v.endswith("y") and len(_v) > 2 and _v[-2] not in "aeiou":
        _VERB_FORMS.add(_v[:-1] + "ies")
        _VERB_FORMS.add(_v[:-1] + "ied")
        _VERB_FORMS.add(_v + "ing")
    else:
        _VERB_FORMS.add(_v + "ing")
        _VERB_FORMS.add(_v + "ed")
        if len(_v) > 2 and _v[-1] not in "aeiouwxy" and _v[-2] in "aeiou" \
                and _v[-3] not in "aeiou":
            # CVC doubling: run->running, sit->sitting
            _VERB_FORMS.add(_v + _v[-1] + "ing")
            _VERB_FORMS.add(_v + _v[-1] + "ed")

# Irregular past/participle forms
_VERB_FORMS |= {"went", "gone", "got", "gotten", "made", "took", "taken",
                "came", "saw", "seen", "found", "gave", "given", "told",
                "said", "spoke", "spoken", "ran", "sat", "stood", "lay",
                "laid", "turned", "brought", "wrote", "written", "ate",
                "eaten", "drank", "drunk", "drove", "driven", "rode",
                "ridden", "flew", "flown", "swam", "swum", "fell", "fallen",
                "threw", "thrown", "caught", "held", "broke", "broken",
                "built", "drew", "drawn", "sang", "sung", "slept", "woke",
                "woken", "wore", "worn", "bought", "sold", "paid", "won",
                "lost", "fought", "met", "taught", "left", "kept", "began",
                "begun", "heard", "hung", "hit", "put", "let", "shot"}

_NOUN_SUFFIX = re.compile(
    r".{2,}(tion|sion|ment|ness|ity|ance|ence|ship|hood|dom|ism|ist|"
    r"er|or|ian|eer|ette|let)s?$")
_ADJ_SUFFIX = re.compile(
    r".{2,}(ous|ful|ive|able|ible|ish|less|ic|ical|ary|ant|ent)$")
_ADV_SUFFIX = re.compile(r".{2,}ly$")


def tag_word(word: str, prev_tag: str = "") -> str:
    """Coarse POS for one lowercased word; ``prev_tag`` enables the two
    context rules that matter for captions (after-DET -> nominal, after
    AUX -> -ing/-ed is verbal)."""
    w = word.lower()
    if not w:
        return "X"
    if w.isdigit() or re.fullmatch(r"\d+(\.\d+)?(th|st|nd|rd)?", w):
        return "NUM"
    tag = _CLOSED.get(w)
    if tag is not None:
        # "open"/"empty"/... are in both ADJ and verb lexicons; after an
        # AUX/PRON they act as verbs ("she opens", "is open" stays ADJ)
        if tag == "ADJ" and w in _VERB_FORMS and prev_tag in ("PRON", "NOUN",
                                                             "PROPN"):
            return "VERB"
        return tag
    if w in _VERB_FORMS:
        # determiner context forces nominal reading: "a run", "the cut"
        if prev_tag == "DET" and not w.endswith("ing"):
            return "NOUN"
        return "VERB"
    if _ADV_SUFFIX.match(w):
        return "ADV"
    if w.endswith("ing") and len(w) > 4:
        return "NOUN" if prev_tag == "DET" else "VERB"
    if w.endswith("ed") and len(w) > 3 and prev_tag in ("AUX", "PRON",
                                                        "NOUN", "PROPN"):
        return "VERB"
    if _ADJ_SUFFIX.match(w):
        return "ADJ"
    if _NOUN_SUFFIX.match(w):
        return "NOUN"
    if word[:1].isupper():
        return "PROPN"
    # default for unknown caption words: nominal (objects dominate)
    return "NOUN"


def tag_words(words: Sequence[str]) -> List[str]:
    tags: List[str] = []
    prev = ""
    for w in words:
        t = tag_word(w, prev)
        tags.append(t)
        prev = t
    return tags


def content_word_indices(words: Sequence[str]) -> List[int]:
    """Word indices the reference's scene-graph picker would select:
    NOUN/PROPN words plus all words inside verb-phrase spans matching the
    spaCy pattern ``VERB? ADV* AUX* VERB+`` (loading.py:259-276 noun pick
    :280-283). Order: nouns first, then verb-phrase words — matching the
    reference's ``object_idxs + verb_idxs`` concatenation (:286)."""
    tags = tag_words(words)
    nouns = [i for i, t in enumerate(tags) if t in ("NOUN", "PROPN")]
    # verb phrases: union of spans matching VERB? ADV* AUX* VERB+ over the
    # tag sequence (greedy left-to-right covers every token any spaCy
    # match would include, since sub-matches are subsets of maximal spans)
    chars = "".join(
        {"VERB": "V", "ADV": "R", "AUX": "A"}.get(t, "O") for t in tags)
    in_phrase: List[int] = []
    for m in re.finditer(r"V?R*A*V+", chars):
        in_phrase.extend(range(m.start(), m.end()))
    seen = set()
    out = []
    for i in nouns + in_phrase:
        if i not in seen:
            seen.add(i)
            out.append(i)
    return out
