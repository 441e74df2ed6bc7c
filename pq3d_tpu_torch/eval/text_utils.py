"""Text normalization for generative QA evaluation; copy of
``pq3d_tpu/eval/text_utils.py``.

Behavior-equivalent to the reference's answer cleaning rules
(reference: data/data_utils.py:450-507 ``clean_answer``): lowercase,
whitespace/punctuation normalization, common typo fixes, digit->word
mapping, article stripping.
"""
from __future__ import annotations

import re

_TYPOS = {
    "letf": "left", "let": "left", "tehre": "there", "rigth": "right",
    "rght": "right", "behine": "behind", "tv": "TV", "chai": "chair",
    "wasing": "washing", "waslked": "walked", "oclock": "o'clock",
    "backwards": "backward",
}
_DIGITS = {
    "0": "zero", "none": "zero", "1": "one", "2": "two", "3": "three",
    "4": "four", "5": "five", "6": "six", "7": "seven", "8": "eight",
    "9": "nine", "10": "ten", "11": "eleven", "12": "twelve",
    "13": "thirteen", "14": "fourteen", "15": "fifteen", "16": "sixteen",
    "17": "seventeen", "18": "eighteen", "19": "nineteen", "20": "twenty",
    "23": "twenty-three",
}


def clean_answer(text: str) -> str:
    t = text.lower().strip()
    t = re.sub(r" {2,}", " ", t)
    t = re.sub(r"\.[ ]{2,}", ". ", t)
    t = re.sub(r"[^a-zA-Z0-9,'\s\-:]+", "", t)
    t = t.replace("ç", "c").replace("’", "'")
    for bad, good in _TYPOS.items():
        t = re.sub(rf"\b{bad}\b", good, t)
    t = re.sub(r"\bo'[ ]+clock\b", "o'clock", t)
    for d, w in _DIGITS.items():
        t = re.sub(rf"\b{d}\b", w, t)
    t = re.sub(r"\b([a-zA-Z]+)([0-9])\b", r"\g<1>", t)   # mat2 -> mat
    t = re.sub(r"\ba\b ([a-zA-Z]+)", r"\g<1>", t)
    t = re.sub(r"\ban\b ([a-zA-Z]+)", r"\g<1>", t)
    t = re.sub(r"\bthe\b ([a-zA-Z]+)", r"\g<1>", t)
    return t


def answer_match(pred: str, gts) -> bool:
    """Exact or squeezed-substring match (ref sqa3d_eval.py:75-83)."""
    for gt in gts:
        if pred == gt:
            return True
        if "".join(pred.split()) in "".join(gt.split()):
            return True
        if "".join(gt.split()) in "".join(pred.split()):
            return True
    return False
