"""Caption metrics: corpus BLEU-4, ROUGE-L, CIDEr-D, METEOR-lite (pure
Python); copy of ``pq3d_tpu/eval/caption_metrics.py``.

Clean-room implementations of the standard algorithms used by the
reference's vendored scorers (reference: evaluator/capeval/{bleu,rouge,
cider}) for Scan2Cap evaluation.  METEOR requires a Java jar in the
reference (evaluator/capeval/meteor/meteor.py:20-27) and is optional here.

All functions take ``preds: dict[key, [caption]]`` and
``refs: dict[key, [captions...]]`` with pre-tokenized (whitespace) strings,
matching the pycocoevalcap calling convention.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def corpus_bleu(preds: Dict, refs: Dict, max_n: int = 4
                ) -> Tuple[List[float], Dict[str, List[float]]]:
    """Corpus-level BLEU-1..4 with clipping + closest-length brevity penalty."""
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len, ref_len = 0, 0
    for k, ps in preds.items():
        p = ps[0].split()
        rs = [r.split() for r in refs[k]]
        pred_len += len(p)
        ref_len += min((abs(len(r) - len(p)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            pg = _ngrams(p, n)
            max_ref = Counter()
            for r in rs:
                rg = _ngrams(r, n)
                for g, c in rg.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += sum(pg.values())
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in pg.items())
    precisions = [clipped[i] / totals[i] if totals[i] else 0.0
                  for i in range(max_n)]
    bp = 1.0 if pred_len > ref_len else \
        math.exp(1 - ref_len / max(pred_len, 1))
    bleus = []
    for n in range(1, max_n + 1):
        if min(precisions[:n]) > 0:
            gm = math.exp(sum(math.log(p) for p in precisions[:n]) / n)
        else:
            gm = 0.0
        bleus.append(bp * gm)
    return bleus, {}


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(preds: Dict, refs: Dict, beta: float = 1.2) -> float:
    scores = []
    for k, ps in preds.items():
        p = ps[0].split()
        # official pycocoevalcap semantics (ref capeval/rouge/rouge.py:68-74;
        # pinned by test_caption_metrics_parity): precision and recall are
        # EACH maxed over the references (possibly different refs), then
        # combined into one F-beta
        prec_max = rec_max = 0.0
        for r in refs[k]:
            rt = r.split()
            lcs = _lcs_len(p, rt)
            prec_max = max(prec_max, lcs / max(len(p), 1))
            rec_max = max(rec_max, lcs / max(len(rt), 1))
        if prec_max and rec_max:
            f = ((1 + beta ** 2) * prec_max * rec_max) / (
                rec_max + beta ** 2 * prec_max)
        else:
            f = 0.0
        scores.append(f)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def meteor(preds: Dict, refs: Dict, jar_path: str = None) -> float:
    """Optional METEOR via the benchmark's Java jar when present
    (the reference shells out to meteor-1.5.jar,
    evaluator/capeval/meteor/meteor.py:20-27).  Returns nan when no jar/JVM
    is available — METEOR is optional in this framework."""
    import os
    import shutil
    import subprocess
    jar = jar_path or os.environ.get("METEOR_JAR", "")
    if not jar or not os.path.exists(jar) or not shutil.which("java"):
        return float("nan")
    lines_test, lines_ref = [], []
    for k in preds:
        lines_test.append(preds[k][0])
        lines_ref.append(refs[k][0])
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".tst", delete=False) as ft, \
            tempfile.NamedTemporaryFile("w", suffix=".ref", delete=False) as fr:
        ft.write("\n".join(lines_test))
        fr.write("\n".join(lines_ref))
        tst, ref = ft.name, fr.name
    out = subprocess.run(["java", "-jar", jar, tst, ref, "-norm"],
                         capture_output=True, text=True, timeout=600)
    for line in reversed(out.stdout.splitlines()):
        if line.lower().startswith("final score"):
            return float(line.split(":")[1])
    return float("nan")


def porter_stem(word: str) -> str:
    """Porter (1980) stemming algorithm, clean-room condensed implementation
    (steps 1a-5b) for the METEOR-lite stem matcher."""
    w = word.lower()
    if len(w) <= 2:
        return w
    vowels = "aeiou"

    def is_cons(s, i):
        c = s[i]
        if c in vowels:
            return False
        if c == "y":
            return i == 0 or not is_cons(s, i - 1)
        return True

    def measure(s):
        # number of VC sequences in the C?(VC)^m V? form
        m, prev_v = 0, False
        for i in range(len(s)):
            v = not is_cons(s, i)
            if prev_v and not v:
                m += 1
            prev_v = v
        return m

    def has_vowel(s):
        return any(not is_cons(s, i) for i in range(len(s)))

    def ends_cvc(s):
        if len(s) < 3:
            return False
        if not (is_cons(s, -3 + len(s)) and not is_cons(s, len(s) - 2)
                and is_cons(s, len(s) - 1)):
            return False
        return s[-1] not in "wxy"

    # step 1a
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
        if w.endswith(suf):
            w = w[:-len(suf)] + rep
            break
    # step 1b
    flag = False
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and has_vowel(w[:-2]):
        w, flag = w[:-2], True
    elif w.endswith("ing") and has_vowel(w[:-3]):
        w, flag = w[:-3], True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif (len(w) >= 2 and w[-1] == w[-2] and is_cons(w, len(w) - 1)
              and w[-1] not in "lsz"):
            w = w[:-1]
        elif measure(w) == 1 and ends_cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # steps 2-4 (suffix tables; applied when the stem measure qualifies)
    step2 = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"),
             ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
             ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
             ("iviti", "ive"), ("biliti", "ble"))
    step3 = (("icate", "ic"), ("ative", ""), ("alize", "al"),
             ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""))
    step4 = (("al", ""), ("ance", ""), ("ence", ""), ("er", ""), ("ic", ""),
             ("able", ""), ("ible", ""), ("ant", ""), ("ement", ""),
             ("ment", ""), ("ent", ""), ("ion", ""), ("ou", ""), ("ism", ""),
             ("ate", ""), ("iti", ""), ("ous", ""), ("ive", ""), ("ize", ""))
    for table, min_m in ((step2, 0), (step3, 0), (step4, 1)):
        for suf, rep in table:
            if w.endswith(suf):
                stem = w[:-len(suf)]
                if measure(stem) > min_m:
                    if suf == "ion" and (not stem or stem[-1] not in "st"):
                        continue
                    w = stem + rep
                break
    # step 5a
    if w.endswith("e"):
        m = measure(w[:-1])
        if m > 1 or (m == 1 and not ends_cvc(w[:-1])):
            w = w[:-1]
    # step 5b
    if (len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and measure(w) > 1):
        w = w[:-1]
    return w


def _meteor_align(hyp: List[str], ref: List[str]):
    """Staged 1-1 alignment (exact, then stem) and its chunk count.

    Clean-room reduction of METEOR's matcher stages (no WordNet synonyms /
    paraphrase tables — not available offline); in-order greedy matching
    within each stage approximates the jar's min-chunk beam search.
    Returns (pairs, weights) with pairs sorted by hyp position.
    """
    used_h = [False] * len(hyp)
    used_r = [False] * len(ref)
    pairs = []   # (hyp_i, ref_j, weight)
    for weight, key in ((1.0, lambda t: t), (0.6, porter_stem)):
        rkeys = [key(t) for t in ref]
        for i, t in enumerate(hyp):
            if used_h[i]:
                continue
            hk = key(t)
            for j, rk in enumerate(rkeys):
                if not used_r[j] and hk == rk:
                    used_h[i] = used_r[j] = True
                    pairs.append((i, j, weight))
                    break
    pairs.sort()
    chunks = 0
    prev = None
    for i, j, _ in pairs:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            chunks += 1
        prev = (i, j)
    return pairs, chunks


def meteor_lite(preds: Dict, refs: Dict, alpha: float = 0.9,
                beta: float = 3.0, gamma: float = 0.5) -> float:
    """Pure-python METEOR (Banerjee & Lavie 2005 scoring: Fmean =
    P*R/(0.9P+0.1R), penalty = 0.5*(chunks/matches)^3) with exact +
    Porter-stem matcher stages (no WordNet synonym module).

    Always available — reported alongside the jar-based ``meteor`` (which
    the reference shells out to and which stays the parity-comparable
    number when a jar is present).
    """
    scores = []
    for k in preds:
        hyp = preds[k][0].split()
        best = 0.0
        for r in refs.get(k, []):
            ref = r.split()
            if not hyp or not ref:
                continue
            pairs, chunks = _meteor_align(hyp, ref)
            if not pairs:
                continue
            m = sum(wt for _, _, wt in pairs)
            p_ = m / len(hyp)
            r_ = m / len(ref)
            if p_ + r_ == 0:
                continue
            fmean = p_ * r_ / (alpha * p_ + (1 - alpha) * r_)
            frag = chunks / len(pairs)
            score = (1 - gamma * frag ** beta) * fmean
            best = max(best, score)
        scores.append(best)
    return float(sum(scores) / len(scores)) if scores else float("nan")


def cider_d(preds: Dict, refs: Dict, max_n: int = 4, sigma: float = 6.0
            ) -> float:
    # document frequencies from the reference corpus
    df = [defaultdict(float) for _ in range(max_n)]
    for k, rs in refs.items():
        for n in range(1, max_n + 1):
            seen = set()
            for r in rs:
                seen.update(_ngrams(r.split(), n).keys())
            for g in seen:
                df[n - 1][g] += 1
    log_m = math.log(max(len(refs), 1))

    def tfidf_vec(tokens: List[str], n: int):
        # raw term frequency * idf (matches pycocoevalcap CIDEr-D, which
        # does NOT normalize counts by ngram total)
        cnt = _ngrams(tokens, n)
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            idf = log_m - math.log(max(df[n - 1][g], 1.0))
            w = c * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm), len(tokens)

    scores = []
    for k, ps in preds.items():
        p = ps[0].split()
        score_n = []
        for n in range(1, max_n + 1):
            pv, pn, pl = tfidf_vec(p, n)
            s = 0.0
            for r in refs[k]:
                rt = r.split()
                rv, rn, rl = tfidf_vec(rt, n)
                # clipped cosine (CIDEr-D clips pred counts to ref)
                num = sum(min(pv.get(g, 0), rv[g]) * rv[g] for g in rv)
                if pn and rn:
                    sim = num / (pn * rn)
                else:
                    sim = 0.0
                delta = pl - rl
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                s += sim
            score_n.append(s / max(len(refs[k]), 1))
        scores.append(10.0 * sum(score_n) / max_n)
    return sum(scores) / max(len(scores), 1)
