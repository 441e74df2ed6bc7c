"""The port's stage-2 evaluators against the JAX package's on the CPU: each
evaluator's ``record()`` on the same predictions and batches (several
``update`` calls each, made from a seed) equals JAX's exactly; the caption
metrics, METEOR-lite's Porter stemmer and the answer cleaning equal JAX's
exactly on fixed strings, empty predictions included; and
``truncate_batch_rows`` cuts what JAX's cuts.  Boxes are dyadic (multiples
of 1/8), so both IoU formulas give the same floats."""
import numpy as np
import pytest

from pq3d_tpu.eval import base as jbase
from pq3d_tpu.eval import caption_eval as jcap
from pq3d_tpu.eval import caption_metrics as jcm
from pq3d_tpu.eval import grounding_eval as jground
from pq3d_tpu.eval import qa_eval as jqa
from pq3d_tpu.eval import text_utils as jtext
from pq3d_tpu_torch.eval import base as tbase
from pq3d_tpu_torch.eval import caption_eval as tcap
from pq3d_tpu_torch.eval import caption_metrics as tcm
from pq3d_tpu_torch.eval import grounding_eval as tground
from pq3d_tpu_torch.eval import qa_eval as tqa
from pq3d_tpu_torch.eval import text_utils as ttext

WORDS = ["the", "a", "red", "chair", "table", "left", "of", "near",
         "sofa", "small", "large", "lamp", "two", "3", "running", "runs"]


def _boxes(rng, *shape):
    centre = rng.integers(-16, 16, shape + (3,)) / 8
    size = rng.integers(1, 16, shape + (3,)) / 8
    return np.concatenate([centre, size], -1).astype(np.float32)


def _sentence(rng, lo=0, hi=6):
    return " ".join(rng.choice(WORDS, rng.integers(lo, hi)))


def _grounding_batches(rng, n=3, b=5, o=7):
    for _ in range(n):
        logits = rng.standard_normal((b, o)).astype(np.float32) * 2
        tgt = rng.integers(0, o, (b,))
        onehot = np.zeros((b, o), np.float32)
        onehot[np.arange(b), tgt] = 1
        iou = (rng.random((b, o)) < 0.3).astype(np.float32)
        iou[np.arange(b), tgt] = 1
        batch = {"tgt_object_id": tgt[:, None],
                 "tgt_object_id_iou25": iou,
                 "tgt_object_id_iou50": iou * (rng.random((b, o)) < 0.7),
                 "is_multiple": rng.random(b) < 0.5,
                 "is_hard": rng.random(b) < 0.5,
                 "is_view_dependent": rng.random(b) < 0.5,
                 "obj_boxes": _boxes(rng, b, o),
                 "query_pad_masks": np.arange(o)[None] < rng.integers(
                     3, o + 1, (b, 1)),
                 "tgt_obj_boxes": [_boxes(rng, int(k)) for k in
                                   rng.integers(0, 3, b)],
                 "eval_type": list(rng.choice(
                     ["zt_w_d", "zt_wo_d", "st_w_d", "st_wo_d", "mt"], b))}
        yield {"og3d_logits": logits}, batch
        # the BCE-label form of the same targets
        yield {"og3d_logits": logits}, dict(batch, tgt_object_id=onehot)


def _qa_batches(rng, n=3, b=6, v=12):
    for _ in range(n):
        scores = rng.standard_normal((b, v)).astype(np.float32)
        label = (rng.random((b, v)) < 0.15).astype(np.float32)
        answers = [[_sentence(rng, 1, 3) for _ in range(rng.integers(1, 3))]
                   for _ in range(b)]
        preds = [a[0] if rng.random() < 0.4 else _sentence(rng)
                 for a in answers]
        yield ({"answer_scores": scores, "answer_pred": preds},
               {"answer_label": label, "answers": answers,
                "sqa_type": rng.integers(0, 6, b)})


def _caption_batches(rng, n=3, b=5):
    k = 0
    for _ in range(n):
        preds = [_sentence(rng) for _ in range(b)]    # some empty
        keys = [f"obj{(k + i) % 11}" for i in range(b)]
        k += b
        refs = [[_sentence(rng, 1, 7) for _ in range(rng.integers(1, 3))]
                for _ in range(b)]
        batch = {"corpus_key": keys, "ref_captions": refs}
        form = rng.integers(0, 3)
        if form == 0:
            batch["iou"] = rng.random(b)
        elif form == 1:
            batch["pred_boxes"] = _boxes(rng, b)
            batch["gt_boxes"] = _boxes(rng, b)
        yield {"caption_pred": preds}, batch


EVALUATORS = {
    "ScanReferEval": (_grounding_batches, jground, tground),
    "ReferIt3DEval": (_grounding_batches, jground, tground),
    "Multi3DReferEval": (_grounding_batches, jground, tground),
    "ScanQAEval": (_qa_batches, jqa, tqa),
    "ScanQAGenEval": (_qa_batches, jqa, tqa),
    "SQA3DEval": (_qa_batches, jqa, tqa),
    "SQA3DGenEval": (_qa_batches, jqa, tqa),
    "Scan2CapEval": (_caption_batches, jcap, tcap),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluator_record_matches_jax(name, tmp_path):
    make, jmod, tmod = EVALUATORS[name]
    jev = getattr(jmod, name)()
    tev = getattr(tmod, name)(save_dir=str(tmp_path))
    for rounds in range(2):              # record, reset, record again
        jev.reset()
        tev.reset()
        for out, batch in make(np.random.default_rng(rounds)):
            jev.update(out, batch)
            tev.update(out, batch)
        want, got = jev.record(), tev.record()
        assert got == want
        assert "target_metric" in got and tev.total_count == jev.total_count
    assert (tmp_path / "results.json").exists()


CAPTION_SETS = [
    ({"a": ["the red chair"], "b": ["a small lamp near the sofa"],
      "c": [""], "d": ["two running chairs runs"]},
     {"a": ["the red chair", "a red chair near the table"],
      "b": ["the small lamp"], "c": ["a sofa"],
      "d": ["two chairs running", "runs"]}),
    ({"a": [""], "b": [""]}, {"a": ["x y"], "b": ["y"]}),
    ({"a": ["sos the chair eos"]}, {"a": ["sos the chair eos"]}),
]


@pytest.mark.parametrize("metric", ["corpus_bleu", "rouge_l", "cider_d",
                                    "meteor_lite"])
@pytest.mark.parametrize("case", range(len(CAPTION_SETS)))
def test_caption_metrics_equal_jax(metric, case):
    preds, refs = CAPTION_SETS[case]
    assert getattr(tcm, metric)(preds, refs) == \
        getattr(jcm, metric)(preds, refs)


def test_porter_stem_and_answer_cleaning_equal_jax():
    words = ["running", "caresses", "ponies", "agreed", "plastered",
             "motoring", "happy", "relational", "conditional", "rational",
             "valenci", "hesitanci", "digitizer", "conformabli", "radicalli",
             "differentli", "vileli", "analogousli", "vietnamization",
             "predication", "operator", "feudalism", "decisiveness",
             "hopefulness", "callousness", "formaliti", "sensitiviti",
             "sensibiliti", "triplicate", "formative", "formalize",
             "electriciti", "electrical", "hopeful", "goodness", "revival",
             "allowance", "inference", "airliner", "gyroscopic",
             "adjustable", "defensible", "irritant", "replacement",
             "adjustment", "dependent", "adoption", "homologou", "communism",
             "activate", "angulariti", "homologous", "effective", "bowdlerize",
             "probate", "rate", "cease", "controll", "roll", "sky", "a", ""]
    assert [tcm.porter_stem(w) for w in words] == \
        [jcm.porter_stem(w) for w in words]
    texts = ["The   Left one!", "3", "an apple", "mat2", "o' clock",
             "tv letf  of the chai.", "Two   Chairs, 10 tables", ""]
    assert [ttext.clean_answer(t) for t in texts] == \
        [jtext.clean_answer(t) for t in texts]
    for pred, gts in (("left", ["the left", "right"]), ("red", ["blue"]),
                      ("two chairs", ["twochairs"]), ("", ["x"])):
        assert ttext.answer_match(pred, gts) == jtext.answer_match(pred, gts)


def test_truncate_batch_rows_equals_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.random((4, 3)), "b": [rng.random((4, 2)),
                                           rng.random((4, 5))],
            "answer_pred": ["w", "x", "y", "z"], "scene": rng.random((2, 4)),
            "nested": {"c": rng.random((4,)), "short": [1, 2]}}
    got = tbase.truncate_batch_rows(tree, 3, 4)
    want = jbase.truncate_batch_rows(tree, 3, 4)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return type(a) is type(b) and len(a) == len(b) and all(
                same(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)
    assert same(got, want)
    assert got["answer_pred"] == ["w", "x", "y"] \
        and got["scene"].shape == (2, 4)
    assert tbase.truncate_batch_rows(tree, 4, 4) is tree
