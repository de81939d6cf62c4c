"""The benchmark's generator: the same seed gives the same inputs, and
another seed the same sizes in another order."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import traffic as TR  # noqa: E402

CORPUS = {"sites": [[{"name": "a", "share": 1.0}, {"name": "b", "share": 3.0}], [{"name": "c", "share": 1.0}]],
          "chunks_per_site": 40, "words": [5, 12], "word_pool": 300, "word_zipf_s": 1.1}
SETS = [{"name": "x", "count": 30, "words": [4, 9]}, {"name": "y", "count": 10, "words": [20, 30]}]


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _batch(**kw):
    t = {"loop": "offline", "question_sets": SETS, "popularity": {"kind": "unique"},
         "answer_tokens": {"dist": "loguniform", "lo": 4, "hi": 64}}
    t.update(kw)
    return t


def test_same_seed_same_inputs():
    big = 2**31 + 12345
    a, b = TR.make_corpus(CORPUS, big), TR.make_corpus(CORPUS, big)
    assert a.texts.strings == b.texts.strings and a.sub == b.sub
    t = _batch()
    sa, sb = TR.make_schedule(t, a, big), TR.make_schedule(t, b, big)
    assert sa.questions.strings == sb.questions.strings
    for f in ("qid", "budget"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))


@pytest.mark.parametrize("answers", [{"dist": "loguniform", "lo": 4, "hi": 64}, {"dist": "fixed", "tokens": 8}])
def test_other_seed_same_work_other_content(answers):
    t = _batch(answer_tokens=answers)
    c1, c2 = TR.make_corpus(CORPUS, 1), TR.make_corpus(CORPUS, 2)
    assert c1.texts.strings != c2.texts.strings
    assert sorted(np.diff(c1.texts.offsets)) == sorted(np.diff(c2.texts.offsets))
    assert sorted(c1.sub) == sorted(c2.sub)
    s1, s2 = TR.make_schedule(t, c1, 1), TR.make_schedule(t, c2, 2)
    # every seed offers the same question lengths and budgets; the words and the order move
    assert s1.questions.strings != s2.questions.strings
    assert sorted(np.diff(s1.questions.offsets)) == sorted(np.diff(s2.questions.offsets))
    np.testing.assert_array_equal(np.sort(s1.budget), np.sort(s2.budget))
    if answers["dist"] == "loguniform":
        assert not np.array_equal(s1.budget, s2.budget)


def test_offline_batch_asks_every_question_once():
    t = _traffic("mcq-offline")
    n = TR.n_requests(t)
    assert n == 1089 + 1273 + 4183 + 500 + 618
    s = TR.make_schedule(t, TR.make_corpus(CORPUS, 3), 3)
    assert len(set(s.qid.tolist())) == n and (s.budget == 8).all()
    lengths = np.diff(s.questions.offsets)
    assert lengths.min() == 6 and lengths.max() == 260  # BioASQ's shortest, MedQA's longest


def test_worked_answers_spread_log_uniformly():
    t = _traffic("explain-offline")
    s = TR.make_schedule(t, TR.make_corpus(CORPUS, 5), 5)
    b = s.budget
    assert b.min() == 64 and b.max() == 256 and abs(np.median(b) - 128) <= 1


def test_shares_split_a_site_by_largest_remainder():
    counts = TR.largest_remainder(1000, 1.0 / np.arange(1, 513) ** 1.1)
    assert counts.sum() == 1000 and counts[0] == counts.max() and 170 < counts[0] < 200
    c = TR.make_corpus(CORPUS, 6)
    assert c.sub.count("a") == 10 and c.sub.count("b") == 30 and c.sub.count("c") == 40


def test_only_offline_batches_of_unique_questions():
    c = TR.make_corpus(CORPUS, 7)
    with pytest.raises(ValueError):
        TR.make_schedule(_batch(loop="open"), c, 7)
    with pytest.raises(ValueError):
        TR.make_schedule(_batch(popularity={"kind": "zipf", "s": 1.1, "pool": 8}), c, 7)
