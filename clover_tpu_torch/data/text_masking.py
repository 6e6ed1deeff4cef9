"""MLM masking engines (host-side, numpy).

Rebuilds the reference BertTokenizer pipeline's masking modes
(mmaction/datasets/pipelines/loading.py:129-390):

- ``hf_style``     — 15% selection with the 80/10/10 mask/random/keep split
                     (loading.py:129-168);
- ``whole_word``   — word-aligned masking over '##' continuation groups
                     (loading.py:291-339);
- ``content_word`` — priority masking of content (non-stop) words. The
                     reference uses spaCy + SceneGraphParser to pick
                     object/verb phrases (loading.py:226-288,340-390);
                     spaCy is unavailable here, so the same intent — bias
                     masking toward semantically loaded words — is realized
                     with a stop-word prior. A true parser can be plugged in
                     via the ``priority_fn`` hook.

All functions return ``(masked_ids, mlm_label)`` where mlm_label holds the
original id at masked positions and IGNORE_INDEX (-100) elsewhere.

Port of ``clover_tpu/data/text_masking.py``: a copy, held against it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from clover_tpu_torch.data.stop_words import ENGLISH_STOP_WORDS
from clover_tpu_torch.data.tokenization import BertTokenizer

IGNORE_INDEX = -100


def _word_groups(ids: np.ndarray, tokenizer: BertTokenizer) -> List[List[int]]:
    """Group token positions into whole words; specials/padding excluded."""
    groups: List[List[int]] = []
    for pos, tid in enumerate(ids):
        tid = int(tid)
        if tid in tokenizer.special_ids:
            continue
        tok = tokenizer.inv_vocab.get(tid, "")
        if tok.startswith("##") and groups:
            groups[-1].append(pos)
        else:
            groups.append([pos])
    return groups


def _apply_801010(
    ids: np.ndarray,
    positions: Sequence[int],
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    masked = ids.copy()
    label = np.full_like(ids, IGNORE_INDEX)
    for pos in positions:
        label[pos] = ids[pos]
        r = rng.random()
        if r < 0.8:
            masked[pos] = tokenizer.mask_id
        elif r < 0.9:
            masked[pos] = rng.integers(0, tokenizer.vocab_size)
        # else: keep original
    return masked, label


def hf_style_mask(
    ids: np.ndarray,
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray]:
    candidates = [
        p for p, t in enumerate(ids) if int(t) not in tokenizer.special_ids]
    selected = [p for p in candidates if rng.random() < mlm_probability]
    return _apply_801010(ids, selected, tokenizer, rng)


def whole_word_mask(
    ids: np.ndarray,
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
    max_predictions: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    groups = _word_groups(ids, tokenizer)
    rng.shuffle(groups)
    n_tokens = sum(len(g) for g in groups)
    num_to_predict = min(max_predictions, max(1, round(n_tokens * mlm_probability)))
    selected: List[int] = []
    for g in groups:
        if len(selected) >= num_to_predict:
            break
        if len(selected) + len(g) > num_to_predict and selected:
            continue
        selected.extend(g)
    return _apply_801010(ids, selected, tokenizer, rng)


def content_word_mask(
    ids: np.ndarray,
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
    max_predictions: int = 20,
    priority_fn: Optional[Callable[[str], bool]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-word masking biased toward content words.

    ``priority_fn(word) -> bool`` marks high-priority words; defaults to
    "not an English stop word". Priority words are exhausted (in random
    order) before any stop word is considered.
    """
    if priority_fn is None:
        def priority_fn(word: str) -> bool:
            return word not in ENGLISH_STOP_WORDS

    groups = _word_groups(ids, tokenizer)

    def group_word(g: List[int]) -> str:
        parts = []
        for pos in g:
            tok = tokenizer.inv_vocab.get(int(ids[pos]), "")
            parts.append(tok[2:] if tok.startswith("##") else tok)
        return "".join(parts)

    prio = [g for g in groups if priority_fn(group_word(g))]
    rest = [g for g in groups if not priority_fn(group_word(g))]
    rng.shuffle(prio)
    rng.shuffle(rest)
    ordered = prio + rest

    n_tokens = sum(len(g) for g in groups)
    num_to_predict = min(max_predictions, max(1, round(n_tokens * mlm_probability)))
    selected: List[int] = []
    for g in ordered:
        if len(selected) >= num_to_predict:
            break
        if len(selected) + len(g) > num_to_predict and selected:
            continue
        selected.extend(g)
    return _apply_801010(ids, selected, tokenizer, rng)


def pos_content_word_mask(
    ids: np.ndarray,
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
    max_predictions: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scene-graph-style masking via the in-repo POS tagger.

    Reference: _whole_word_mask_with_scene_graph + scene_graph_parser_obj_verb
    (loading.py:226-288,340-390) — select NOUN/PROPN words and verb-phrase
    spans (spaCy pattern VERB? ADV* AUX* VERB+), shuffle the selected word
    groups, and mask ``round(len(selected) * p)`` whole groups (counted in
    WORDS, not tokens — the reference's ``count += 1`` per group), then
    apply the 80/10/10 split. Falls back to whole-word masking when the
    tagger finds no content words (the reference would silently mask
    nothing there, which feeds an empty index set to the MLM loss —
    intentional divergence, documented).
    """
    from clover_tpu_torch.data.pos_tagger import content_word_indices

    groups = _word_groups(ids, tokenizer)
    if not groups:
        return _apply_801010(ids, [], tokenizer, rng)

    def group_word(g: List[int]) -> str:
        parts = []
        for pos in g:
            tok = tokenizer.inv_vocab.get(int(ids[pos]), "")
            parts.append(tok[2:] if tok.startswith("##") else tok)
        return "".join(parts)

    words = [group_word(g) for g in groups]
    picked = [groups[i] for i in content_word_indices(words)]
    if not picked:
        return whole_word_mask(ids, tokenizer, rng, mlm_probability,
                               max_predictions)
    rng.shuffle(picked)
    num_to_predict = min(max_predictions,
                         max(1, round(len(picked) * mlm_probability)))
    selected: List[int] = []
    covered: set = set()
    count = 0
    for g in picked:
        if count >= num_to_predict:
            break
        if any(pos in covered for pos in g):
            continue
        covered.update(g)
        selected.extend(g)
        count += 1
    return _apply_801010(ids, selected, tokenizer, rng)


MASK_ENGINES = {
    "hf_style": hf_style_mask,
    "whole_word": whole_word_mask,
    "content_word": content_word_mask,
    "pos_content_word": pos_content_word_mask,
}
