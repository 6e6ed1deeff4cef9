"""WordPiece tokenization (BERT-compatible), self-contained.

Replaces the reference's HF BertTokenizerFast dependency
(mmaction/datasets/pipelines/tokenization.py:15-48) with a host-side
pure-Python implementation of the standard WordPiece algorithm
(lowercase + accent-strip + punctuation-split basic tokenization, then
greedy longest-match-first subword segmentation). At Clover text lengths
(max_length 25-40, SURVEY.md §2.4) python speed is ample; a C++ fast path
can be slotted behind the same interface later.

Vocabulary comes from a standard ``vocab.txt`` (one token per line); token
ids therefore match ``bert-base-uncased`` exactly when given its vocab.

Port of ``clover_tpu/data/tokenization.py``: a copy, held against it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower_case: bool = True) -> List[str]:
    """Whitespace/punct/CJK splitting with optional lowercasing+accent strip."""
    out_chars: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out_chars.append(f" {ch} ")
        elif _is_whitespace(ch):
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    tokens: List[str] = []
    for word in "".join(out_chars).split():
        if lower_case:
            word = word.lower()
            word = "".join(
                c for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn")
        # split punctuation into its own tokens
        cur: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


def wordpiece_tokenize(word: str, vocab: Dict[str, int],
                       max_chars_per_word: int = 100) -> List[str]:
    """Greedy longest-match-first subword split; [UNK] on failure."""
    if len(word) > max_chars_per_word:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        piece = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [UNK]
        pieces.append(piece)
        start = end
    return pieces


class BertTokenizer:
    """Vocabulary-driven BERT tokenizer producing fixed-length id arrays."""

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lower_case = lower_case
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.mask_id = vocab[MASK]
        self.special_ids = frozenset(
            (self.pad_id, self.cls_id, self.sep_id, self.mask_id))

    @classmethod
    def from_vocab_file(cls, path: str, lower_case: bool = True) -> "BertTokenizer":
        return cls(load_vocab(path), lower_case)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for word in basic_tokenize(text, self.lower_case):
            tokens.extend(wordpiece_tokenize(word, self.vocab))
        return tokens

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def encode(
        self,
        text: str,
        max_length: int = 30,
        second_text: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """-> {token_ids, input_mask, segment_ids} shaped (max_length,).

        [CLS] text [SEP] (second [SEP]), truncated then zero-padded —
        the contract of the reference BertTokenizer pipeline
        (datasets/pipelines/loading.py:394-434).
        """
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if second_text is not None:
            ids2 = self.convert_tokens_to_ids(self.tokenize(second_text))
            ids = ids[: max_length - 3]
            ids2 = ids2[: max_length - 3 - len(ids)]
            full = [self.cls_id] + ids + [self.sep_id] + ids2 + [self.sep_id]
            seg = [0] * (len(ids) + 2) + [1] * (len(ids2) + 1)
        else:
            ids = ids[: max_length - 2]
            full = [self.cls_id] + ids + [self.sep_id]
            seg = [0] * len(full)
        mask = [1] * len(full)
        pad_n = max_length - len(full)
        token_ids = np.asarray(full + [self.pad_id] * pad_n, dtype=np.int32)
        input_mask = np.asarray(mask + [0] * pad_n, dtype=np.int32)
        segment_ids = np.asarray(seg + [0] * pad_n, dtype=np.int32)
        return {"token_ids": token_ids, "input_mask": input_mask,
                "segment_ids": segment_ids}

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), UNK) for i in ids]
        out: List[str] = []
        for t in toks:
            if t in (PAD, CLS, SEP):
                continue
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)


def build_test_vocab(words: Sequence[str]) -> Dict[str, int]:
    """Small deterministic vocab for tests/synthetic data: specials +
    whole words + their character pieces."""
    vocab: Dict[str, int] = {}
    for tok in (PAD, UNK, CLS, SEP, MASK):
        vocab[tok] = len(vocab)
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    for w in words:
        for i, ch in enumerate(w):
            piece = ch if i == 0 else "##" + ch
            if piece not in vocab:
                vocab[piece] = len(vocab)
    return vocab
