"""The port's text frontend (``diff_vits_tpu_torch/text``) against the JAX
package's: ``clean_text`` + ``cleaned_text_to_sequence`` + ``intersperse``
(the ids ``infer.tts_infer.preprocess_text`` feeds the model) equal,
exactly, for English sentences (punctuation, out-of-vocabulary words,
numbers; every word through ``english_lts`` with no CMU dictionary, and
through a small dictionary file named by DIFF_VITS_CMUDICT), Japanese kana,
and Mandarin through the jieba/pypinyin stand-ins of
tests/test_zh_g2p_pipeline.py; the same ImportError where a backend is
missing; ``english_lts``, the pinyin lexicon and the Mandarin number
normaliser equal; and every case of tests/test_tone_sandhi.py run against
the port's ``ToneSandhi``."""
import inspect
import sys
import types

import numpy as np
import pytest

import test_tone_sandhi
from diff_vits_tpu.core.masking import intersperse as jintersperse
from diff_vits_tpu.infer.tts_infer import preprocess_text as jpreprocess
from diff_vits_tpu.text import english_lts as jlts
from diff_vits_tpu.text import frontend as jfe
from diff_vits_tpu.text import pinyin_lexicon as jlex
from diff_vits_tpu.text import tone_sandhi as jsandhi
from diff_vits_tpu_torch.core.masking import intersperse
from diff_vits_tpu_torch.infer.tts_infer import preprocess_text
from diff_vits_tpu_torch.text import english_lts as tlts
from diff_vits_tpu_torch.text import frontend as tfe
from diff_vits_tpu_torch.text import pinyin_lexicon as tlex
from diff_vits_tpu_torch.text import tone_sandhi as tsandhi
from test_english_lts_golden import WORDS
from test_zh_g2p_pipeline import _fake_lazy_pinyin, _fake_lcut

EN = [
    "Hello world.",
    "The quick brown fox, jumping over 13 lazy dogs!",
    "Is it gamification or kafkaesque? Who knows; nobody: really.",
    "Cinematography's futurology - relatability, electricity.",
    "  spaces   and\ttabs  ",
    "1234 5.6 !!",
    "Don't stop believin' in zyxwv qwrtp.",
]
JA = ["こんにちは", "きょうはいいてんきですね。", "がっこうへいきます！",
      "ラーメン、ください？", "ぎゅうにゅう、ちゃわん", "ゔーいー"]
ZH = ["你好.", "我们不是一天.", "你好,我们不是.", "一天一天."]


def _ids(fe, mask, text, lang):
    """ids of one text through a package's frontend (as preprocess_text
    builds them)."""
    norm, phones, tones, word2ph = fe.clean_text(text, lang)
    seq = fe.cleaned_text_to_sequence(phones, tones, lang)
    return (norm, phones, tones, word2ph) + tuple(mask(s, 0) for s in seq)


def assert_same_ids(text, lang):
    ours = _ids(tfe, intersperse, text, lang)
    theirs = _ids(jfe, jintersperse, text, lang)
    assert ours == theirs
    assert len(ours[4]) == 2 * len(ours[1]) + 1


@pytest.fixture
def no_cmudict(monkeypatch, tmp_path):
    """Neither package finds a dictionary: every word goes through
    english_lts."""
    monkeypatch.setenv("DIFF_VITS_CMUDICT", str(tmp_path / "missing"))
    for fe in (tfe, jfe):
        monkeypatch.setattr(fe, "_cmudict_cache", {})
    yield


@pytest.mark.parametrize("text", EN)
def test_english_ids_equal_without_a_dictionary(text, no_cmudict):
    assert_same_ids(text, "EN")


@pytest.mark.parametrize("text", EN)
def test_english_ids_equal_with_a_dictionary(text, monkeypatch, tmp_path):
    path = tmp_path / "cmudict.rep"
    path.write_text(";;; a few entries\n"
                    "HELLO  HH AH0 L OW1\nWORLD  W ER1 L D\n"
                    "THE  DH AH0\nTHE(1)  DH IY0\nQUICK  K W IH1 K\n"
                    "DOGS  D AO1 G Z\nIS  IH1 Z\nIT  IH1 T\n",
                    encoding="latin-1")
    monkeypatch.setenv("DIFF_VITS_CMUDICT", str(path))
    for fe in (tfe, jfe):
        monkeypatch.setattr(fe, "_cmudict_cache", None)
    assert_same_ids(text, "EN")
    assert tfe._load_cmudict()["THE"] == ["DH", "AH0"]


def test_preprocess_text_equals_jax(no_cmudict):
    for text in EN:
        for blank in (True, False):
            ours = preprocess_text(text, "EN", blank)
            theirs = jpreprocess(text, "EN", blank)
            for a, b in zip(ours, theirs):
                assert a.dtype == np.int64 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("word", WORDS + ["a", "xylophone", "rhythm",
                                          "queue", "knight", "psychology"])
def test_letter_to_sound_equal(word):
    assert tlts.letter_to_sound(word) == jlts.letter_to_sound(word)


@pytest.mark.parametrize("text", JA)
def test_japanese_kana_ids_equal(text):
    assert_same_ids(text, "JA")


def test_japanese_kanji_and_mandarin_without_backends_raise_alike():
    for fe in (tfe, jfe):
        with pytest.raises(ImportError, match="pyopenjtalk"):
            fe.clean_text("日本語", "JA")
        with pytest.raises(ImportError, match="pypinyin and jieba"):
            fe.clean_text("你好", "ZH")


@pytest.fixture
def zh_backends(monkeypatch):
    """The jieba / pypinyin stand-ins of tests/test_zh_g2p_pipeline.py, and
    no sandhi cached in either package."""
    jieba = types.ModuleType("jieba")
    jieba.cut_for_search = lambda w: [w]
    posseg = types.ModuleType("jieba.posseg")
    posseg.lcut = _fake_lcut
    jieba.posseg = posseg
    pypinyin = types.ModuleType("pypinyin")
    pypinyin.Style = types.SimpleNamespace(INITIALS="INITIALS",
                                           FINALS_TONE3="FINALS_TONE3")
    pypinyin.lazy_pinyin = _fake_lazy_pinyin
    monkeypatch.setitem(sys.modules, "jieba", jieba)
    monkeypatch.setitem(sys.modules, "jieba.posseg", posseg)
    monkeypatch.setitem(sys.modules, "pypinyin", pypinyin)
    for fe in (tfe, jfe):
        monkeypatch.setattr(fe, "_sandhi_cache", None)
    yield


@pytest.mark.parametrize("text", ZH)
def test_mandarin_ids_equal(text, zh_backends):
    assert_same_ids(text, "ZH")


@pytest.mark.parametrize("text", ["2024年，好！", "10005个（苹果）", "3.14",
                                  "嗯……「呣」"])
def test_mandarin_normaliser_equal(text):
    assert tfe.zh_text_normalize(text) == jfe.zh_text_normalize(text)


def test_pinyin_lexicon_equal():
    assert tlex.build_lexicon() == jlex.build_lexicon()
    assert tfe._load_pinyin_lexicon() == jfe._load_pinyin_lexicon()


SANDHI_CASES = sorted(name for name, f in inspect.getmembers(
    test_tone_sandhi, inspect.isfunction) if name.startswith("test_"))


@pytest.mark.parametrize("case", SANDHI_CASES)
def test_tone_sandhi_cases_hold_for_the_port(case, monkeypatch):
    """Each case of tests/test_tone_sandhi.py, with the port's module in
    place of the JAX package's."""
    for name in ("ToneSandhi", "MUST_NEURAL_TONE_WORDS",
                 "MUST_NOT_NEURAL_TONE_WORDS"):
        assert getattr(test_tone_sandhi, name) is getattr(jsandhi, name)
        monkeypatch.setattr(test_tone_sandhi, name, getattr(tsandhi, name))
    getattr(test_tone_sandhi, case)()


def test_tone_sandhi_tables_equal():
    assert tsandhi.MUST_NEURAL_TONE_WORDS == jsandhi.MUST_NEURAL_TONE_WORDS
    assert (tsandhi.MUST_NOT_NEURAL_TONE_WORDS
            == jsandhi.MUST_NOT_NEURAL_TONE_WORDS)
