"""A copy of `uninext_tpu/data/prompts.py` (the port imports nothing of the JAX package).

Detection<->grounding prompt unification (host-side).

Parity anchors (reference data/coco_dataset_mapper_uni.py):
  * convert_object_detection_to_grounding_optimized_for_od — :452-618
    (class-name sentence "person. bicycle. ...", GLIP-style random negative
    sampling + shuffled class order at train, token-count cap control)
  * create_positive_map  — :687-714 (N_obj x max_len map, 1 over the class's
    token span, then row-normalized; binarized model-side)
  * create_queries_and_maps / create_positive_dict — :36,:716 (test-time
    label -> token-indices map for grounding->OD logit conversion)
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import BertTokenizer

SEPARATION_TOKENS = ". "


def build_detection_prompt(categories: Sequence[str]
                           ) -> Tuple[str, List[Tuple[int, int]]]:
    """'person. bicycle. ...' + per-category char spans."""
    spans = []
    parts = []
    pos = 0
    for i, name in enumerate(categories):
        parts.append(name)
        spans.append((pos, pos + len(name)))
        pos += len(name)
        if i < len(categories) - 1:
            parts.append(SEPARATION_TOKENS)
            pos += len(SEPARATION_TOKENS)
    return "".join(parts), spans


def sample_classes_for_training(pos_labels: Sequence[int], num_classes: int,
                                rng: random.Random,
                                max_classes: int = 80,
                                shuffle: bool = True) -> List[int]:
    """GLIP-style negative-class sampling: keep all positives, add random
    negatives up to max_classes, shuffle order."""
    pos = sorted(set(int(l) for l in pos_labels))
    negs = [c for c in range(num_classes) if c not in pos]
    rng.shuffle(negs)
    keep = pos + negs[:max(0, max_classes - len(pos))]
    if shuffle:
        rng.shuffle(keep)
    return keep


def tokenize_with_positive_map(
        text: str, spans_per_object: List[List[Tuple[int, int]]],
        tokenizer: BertTokenizer, max_len: int = 256):
    """Returns (input_ids, attention_mask, positive_map (N, max_len) bool)."""
    tok = tokenizer(text, max_length=max_len)
    c2t = tok["char_to_token"]
    pm = np.zeros((len(spans_per_object), max_len), bool)
    for j, spans in enumerate(spans_per_object):
        for (beg, end) in spans:
            beg_pos = _first_token(c2t, beg, +1)
            end_pos = _first_token(c2t, end - 1, -1)
            if beg_pos < 0 or end_pos < 0:
                continue
            pm[j, beg_pos:end_pos + 1] = True
    return tok["input_ids"], tok["attention_mask"], pm


def _first_token(c2t: np.ndarray, pos: int, step: int, tries: int = 3) -> int:
    for k in range(tries):
        p = pos + step * k
        if 0 <= p < len(c2t) and c2t[p] >= 0:
            return int(c2t[p])
    return -1


def build_parallel_det_mask(cls_token_map: np.ndarray) -> np.ndarray:
    """Block-diagonal (T, T) attention mask for PARALLEL_DET.

    Parity: reference bert_model.py:32-74 — each class name's tokens attend
    only within themselves so independent class prompts don't interact;
    non-class tokens ([CLS]/[SEP]/separators) attend everywhere.
    cls_token_map: (C, T) bool. Returns (T, T) with 1 = may attend."""
    C, T = cls_token_map.shape
    is_class_tok = cls_token_map.any(0)
    same_class = np.zeros((T, T), bool)
    for c in range(C):
        idx = np.flatnonzero(cls_token_map[c])
        same_class[np.ix_(idx, idx)] = True
    allow = same_class | ~is_class_tok[None, :] | ~is_class_tok[:, None]
    return allow.astype(np.int32)


def create_label_token_map(categories: Sequence[str],
                           tokenizer: BertTokenizer,
                           max_len: int = 256
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Test-time prompt + (num_classes, max_len) bool class->token map.

    Used for grounding->OD logit conversion (uninext_img.py:598-610: per-class
    MEAN over its token logits)."""
    text, spans = build_detection_prompt(categories)
    ids, mask, pm = tokenize_with_positive_map(
        text, [[s] for s in spans], tokenizer, max_len)
    return ids, mask, pm
