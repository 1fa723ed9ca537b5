"""Host-side text frontend: phones/tones/language-id encoding + G2P dispatch.

A copy of ``diff_vits_tpu/text/frontend.py:1-433`` (only the imports
differ), so the port gives the ids the JAX package gives:

* ``cleaned_text_to_sequence`` (reference text/__init__.py:6) — exact.
* ``clean_text`` (text/cleaner.py:9) dispatches to per-language G2P.
* Mandarin G2P (text/chinese.py) requires the optional ``pypinyin`` +
  ``jieba`` stack; Japanese uses ``pyopenjtalk`` when installed and covers
  kana only without it; English reads a CMU dictionary file when one is
  found (``DIFF_VITS_CMUDICT``) and sends every other word through the
  rule-based ``english_lts``. Each backend is gated: if its dependency is
  missing it raises a clear error at call time.

BERT features (``get_bert``) are not ported: the ZH path needs downloaded
chinese-roberta weights, and the model never reads them.
"""
from __future__ import annotations

import os
import re
from typing import List, Sequence, Tuple

from diff_vits_tpu_torch.text.symbols import (
    language_id_map,
    language_tone_start_map,
    punctuation,
    symbols,
)

_symbol_to_id = {s: i for i, s in enumerate(symbols)}


def cleaned_text_to_sequence(cleaned_text: Sequence[str], tones: Sequence[int],
                             language: str):
    """phones -> ids, tones += language tone offset, language -> id list.

    Parity: text/__init__.py:6.
    """
    phones = [_symbol_to_id[symbol] for symbol in cleaned_text]
    tone_start = language_tone_start_map[language]
    tones = [i + tone_start for i in tones]
    lang_id = language_id_map[language]
    lang_ids = [lang_id for _ in phones]
    return phones, tones, lang_ids


# ---------------------------------------------------------------------------
# Mandarin G2P (parity: text/chinese.py; needs pypinyin + jieba + a
# pinyin->phoneme lexicon in opencpop-strict format)
# ---------------------------------------------------------------------------

_ZH_REP_MAP = {
    '：': ',', '；': ',', '，': ',', '。': '.', '！': '!', '？': '?',
    '\n': '.', '·': ',', '、': ',', '...': '…', '$': '.',
    '“': "'", '”': "'", '‘': "'", '’': "'", '（': "'", '）': "'",
    '(': "'", ')': "'", '《': "'", '》': "'", '【': "'", '】': "'",
    '[': "'", ']': "'", '—': '-', '～': '-', '~': '-', '「': "'", '」': "'",
}


def _zh_replace_punctuation(text: str) -> str:
    text = text.replace('嗯', '恩').replace('呣', '母')
    pattern = re.compile('|'.join(re.escape(p) for p in _ZH_REP_MAP))
    text = pattern.sub(lambda x: _ZH_REP_MAP[x.group()], text)
    return re.sub(r'[^一-龥' + ''.join(re.escape(p) for p in punctuation) + r']+',
                  '', text)


def _num_to_hanzi(num: str) -> str:
    """Minimal integer/decimal -> hanzi conversion (cn2an fallback)."""
    digits = '零一二三四五六七八九'
    units = ['', '十', '百', '千']
    big_units = ['', '万', '亿', '万亿', '亿亿']

    def int_to_hanzi(n: int) -> str:
        if n == 0:
            return '零'
        groups = []  # low to high, 4 digits each
        while n > 0:
            groups.append(n % 10000)
            n //= 10000
        top = len(groups) - 1
        parts = []
        for gi in range(top, -1, -1):
            g = groups[gi]
            if g == 0:
                continue
            s = ''
            zero_pending = False
            for pos in range(3, -1, -1):
                d = (g // (10 ** pos)) % 10
                if d == 0:
                    if s:
                        zero_pending = True
                    continue
                if zero_pending:
                    s += '零'
                    zero_pending = False
                # 十 not 一十 — only at the head of the whole number
                if not (pos == 1 and d == 1 and g < 100 and gi == top):
                    s += digits[d]
                s += units[pos]
            # inter-group zero: 10005 -> 一万零五 (a skipped group or
            # leading zeros in this group need one 零)
            if parts and g < 1000:
                parts.append('零')
            parts.append(s + big_units[gi])
        return ''.join(parts)

    if '.' in num:
        a, b = num.split('.', 1)
        return int_to_hanzi(int(a)) + '点' + ''.join(digits[int(c)] for c in b)
    return int_to_hanzi(int(num))


def zh_text_normalize(text: str) -> str:
    """Number conversion + punctuation mapping. Parity: chinese.py:169."""
    try:
        import cn2an  # type: ignore
        def an2cn(n):
            return cn2an.an2cn(n)
    except ImportError:
        an2cn = _num_to_hanzi
    for number in re.findall(r'\d+(?:\.?\d+)?', text):
        text = text.replace(number, an2cn(number), 1)
    return _zh_replace_punctuation(text)


_pinyin_lexicon_cache = None
_sandhi_cache = None


def _load_pinyin_lexicon():
    """pinyin -> phone-list map, opencpop-strict format (tab separated).

    Cached at module level; falls back to the generated in-repo table
    (``pinyin_lexicon.build_lexicon``, golden-matched to all 429 reference
    entries) when no lexicon file is present."""
    global _pinyin_lexicon_cache
    if _pinyin_lexicon_cache is not None:
        return _pinyin_lexicon_cache
    path = os.environ.get("DIFF_VITS_PINYIN_LEXICON")
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "opencpop-strict.txt")
    if os.path.exists(path):
        out = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    k, v = line.split("\t")
                    out[k] = v.split(" ")
    else:
        from diff_vits_tpu_torch.text.pinyin_lexicon import build_lexicon
        out = build_lexicon()
    _pinyin_lexicon_cache = out
    return out


_V_REP_MAP = {'uei': 'ui', 'iou': 'iu', 'uen': 'un'}
_PINYIN_REP_MAP = {'ing': 'ying', 'i': 'yi', 'in': 'yin', 'u': 'wu'}
_SINGLE_REP_MAP = {'v': 'yu', 'e': 'e', 'i': 'y', 'u': 'w'}


def zh_g2p(text: str) -> Tuple[List[str], List[int], List[int]]:
    """Mandarin grapheme-to-phoneme. Parity: chinese.py:64-165."""
    try:
        from pypinyin import lazy_pinyin, Style  # type: ignore
        import jieba.posseg as psg  # type: ignore
    except ImportError as e:
        raise ImportError(
            "Mandarin G2P requires pypinyin and jieba; install them or feed "
            "pre-cleaned text (cleaned_text=True).") from e
    from diff_vits_tpu_torch.text.tone_sandhi import ToneSandhi

    pinyin_to_symbol = _load_pinyin_lexicon()
    global _sandhi_cache
    if _sandhi_cache is None:
        _sandhi_cache = ToneSandhi()
    sandhi = _sandhi_cache

    pattern = r'(?<=[{0}])\s*'.format(''.join(punctuation))
    sentences = [i for i in re.split(pattern, text) if i.strip() != '']

    phones_list: List[str] = []
    tones_list: List[int] = []
    word2ph: List[int] = []
    for seg in sentences:
        seg = re.sub('[a-zA-Z]+', '', seg)
        seg_cut = psg.lcut(seg)
        initials, finals = [], []
        seg_cut = sandhi.pre_merge_for_modify(seg_cut)
        for word, pos in seg_cut:
            if pos == 'eng':
                continue
            sub_initials = lazy_pinyin(word, neutral_tone_with_five=True,
                                       style=Style.INITIALS)
            sub_finals = lazy_pinyin(word, neutral_tone_with_five=True,
                                     style=Style.FINALS_TONE3)
            sub_finals = sandhi.modified_tone(word, pos, sub_finals)
            initials += sub_initials
            finals += sub_finals
        for c, v in zip(initials, finals):
            if c == v:
                assert c in punctuation
                phone, tone = [c], '0'
                word2ph.append(1)
            else:
                v_without_tone, tone = v[:-1], v[-1]
                pinyin = c + v_without_tone
                assert tone in '12345'
                if c:
                    if v_without_tone in _V_REP_MAP:
                        pinyin = c + _V_REP_MAP[v_without_tone]
                else:
                    if pinyin in _PINYIN_REP_MAP:
                        pinyin = _PINYIN_REP_MAP[pinyin]
                    elif pinyin[0] in _SINGLE_REP_MAP:
                        pinyin = _SINGLE_REP_MAP[pinyin[0]] + pinyin[1:]
                assert pinyin in pinyin_to_symbol, (pinyin, seg)
                phone = pinyin_to_symbol[pinyin]
                word2ph.append(len(phone))
            phones_list += phone
            tones_list += [int(tone)] * len(phone)

    phones = ['_'] + phones_list + ['_']
    tones = [0] + tones_list + [0]
    word2ph = [1] + word2ph + [1]
    return phones, tones, word2ph


# ---------------------------------------------------------------------------
# English G2P (parity: text/english.py; CMUdict file based)
# ---------------------------------------------------------------------------

_ARPA_RE = re.compile(r'([A-Z]+)([0-9]?)')
_cmudict_cache = None


def _load_cmudict():
    global _cmudict_cache
    if _cmudict_cache is not None:
        return _cmudict_cache
    candidates = [
        os.environ.get("DIFF_VITS_CMUDICT"),
        os.path.join(os.path.dirname(__file__), "cmudict.rep"),
        # common locations for the public-domain CMU dictionary
        # (http://www.speech.cs.cmu.edu/cgi-bin/cmudict — drop cmudict.rep
        # next to this module or set DIFF_VITS_CMUDICT)
        os.path.expanduser("~/nltk_data/corpora/cmudict/cmudict"),
        "/usr/share/dict/cmudict",
    ]
    path = next((p for p in candidates if p and os.path.exists(p)), None)
    if path is None:
        # no dictionary: every word goes through the rule-based LTS
        # (english_lts.letter_to_sound)
        _cmudict_cache = {}
        return _cmudict_cache
    d = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            if line.startswith((';;;', '##')) or not line.strip():
                continue
            parts = line.strip().split('  ')
            if len(parts) < 2:
                parts = line.strip().split(' ', 1)
            word = parts[0].split('(')[0].upper()
            if word not in d:
                d[word] = parts[1].strip().split(' ')
    _cmudict_cache = d
    return d


def en_g2p(text: str) -> Tuple[List[str], List[int], List[int]]:
    """English grapheme-to-phoneme via CMUdict with ARPA stress -> tone.

    Parity: english.py:80-136 (stress digit becomes the tone channel;
    the reference phonemizes unknown words with g2p_en, english.py:103-116
    — here OOV words go through the dependency-free rule LTS,
    english_lts.letter_to_sound, and only letterless tokens become UNK).
    """
    from diff_vits_tpu_torch.text.english_lts import letter_to_sound

    d = _load_cmudict()
    words = re.findall(r"[A-Za-z']+|[.,!?;:]", text)
    phones: List[str] = []
    tones: List[int] = []
    word2ph: List[int] = []
    for w in words:
        if re.match(r"[.,!?;:]", w):
            mapped = {'.': '.', ',': ',', '!': '!', '?': '?', ';': ',', ':': ','}[w]
            phones.append(mapped)
            tones.append(0)
            word2ph.append(1)
            continue
        arpa = d.get(w.upper())
        if arpa is None:
            arpa = letter_to_sound(w)
        if not arpa:
            phones.append('UNK')
            tones.append(0)
            word2ph.append(1)
            continue
        n = 0
        for ph in arpa:
            m = _ARPA_RE.fullmatch(ph)
            if not m:
                continue
            base, stress = m.group(1).lower(), m.group(2)
            if base == 'v':
                base = 'V'
            phones.append(base)
            tones.append(int(stress) + 1 if stress else 0)
            n += 1
        word2ph.append(n)
    phones = ['_'] + phones + ['_']
    tones = [0] + tones + [0]
    word2ph = [1] + word2ph + [1]
    return phones, tones, word2ph


def en_text_normalize(text: str) -> str:
    return text


# ---------------------------------------------------------------------------
# Japanese G2P (parity: text/japanese.py; needs pyopenjtalk)
# ---------------------------------------------------------------------------

# kana -> openjtalk-style phones (the JA symbol set, symbols.py).
# Used when pyopenjtalk is unavailable and the input is pure kana —
# kana-to-phoneme is deterministic; kanji needs the full morphological
# analyzer (text/japanese.py:77 in the reference).
_KANA_BASE = {
    'あ': 'a', 'い': 'i', 'う': 'u', 'え': 'e', 'お': 'o',
    'か': 'k a', 'き': 'k i', 'く': 'k u', 'け': 'k e', 'こ': 'k o',
    'が': 'g a', 'ぎ': 'g i', 'ぐ': 'g u', 'げ': 'g e', 'ご': 'g o',
    'さ': 's a', 'し': 'sh i', 'す': 's u', 'せ': 's e', 'そ': 's o',
    'ざ': 'z a', 'じ': 'j i', 'ず': 'z u', 'ぜ': 'z e', 'ぞ': 'z o',
    'た': 't a', 'ち': 'ch i', 'つ': 'ts u', 'て': 't e', 'と': 't o',
    'だ': 'd a', 'ぢ': 'j i', 'づ': 'z u', 'で': 'd e', 'ど': 'd o',
    'な': 'n a', 'に': 'n i', 'ぬ': 'n u', 'ね': 'n e', 'の': 'n o',
    'は': 'h a', 'ひ': 'h i', 'ふ': 'f u', 'へ': 'h e', 'ほ': 'h o',
    'ば': 'b a', 'び': 'b i', 'ぶ': 'b u', 'べ': 'b e', 'ぼ': 'b o',
    'ぱ': 'p a', 'ぴ': 'p i', 'ぷ': 'p u', 'ぺ': 'p e', 'ぽ': 'p o',
    'ま': 'm a', 'み': 'm i', 'む': 'm u', 'め': 'm e', 'も': 'm o',
    'や': 'y a', 'ゆ': 'y u', 'よ': 'y o',
    'ら': 'r a', 'り': 'r i', 'る': 'r u', 'れ': 'r e', 'ろ': 'r o',
    'わ': 'w a', 'を': 'o', 'ゔ': 'b u',
}
_KANA_DIGRAPH_ONSET = {
    'き': 'ky', 'ぎ': 'gy', 'し': 'sh', 'じ': 'j', 'ち': 'ch',
    'に': 'ny', 'ひ': 'hy', 'び': 'by', 'ぴ': 'py', 'み': 'my',
    'り': 'ry',
}
_SMALL_Y = {'ゃ': 'a', 'ゅ': 'u', 'ょ': 'o'}
_VOWELS = set('aiueoIU')
# JA marks -> the shared punctuation symbols (japanese.py:42-55 rep_map)
_JA_MARKS = {'、': ',', '。': '.', '！': '!', '？': '?', '：': ',',
             '；': ',', '，': ',', '·': ',', '…': '…', '!': '!', '?': '?',
             ',': ',', '.': '.', '-': '-', "'": "'"}


def _kana_to_hiragana(text: str) -> str:
    return ''.join(
        chr(ord(ch) - 0x60) if 'ァ' <= ch <= 'ヶ' else ch for ch in text)


def kana_g2p(text: str) -> List[str]:
    """Deterministic kana -> openjtalk-phone conversion (fallback path)."""
    text = _kana_to_hiragana(text)
    phones: List[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        nxt = text[i + 1] if i + 1 < len(text) else ''
        if ch in _KANA_DIGRAPH_ONSET and nxt in _SMALL_Y:
            phones += [_KANA_DIGRAPH_ONSET[ch], _SMALL_Y[nxt]]
            i += 2
            continue
        if ch == 'っ':
            phones.append('cl')
        elif ch == 'ん':
            phones.append('N')
        elif ch == 'ー':
            last_vowel = next((p for p in reversed(phones)
                               if p in _VOWELS), None)
            if last_vowel:
                phones.append(last_vowel)
        elif ch in _KANA_BASE:
            phones += _KANA_BASE[ch].split(' ')
        elif ch in _JA_MARKS:
            phones.append(_JA_MARKS[ch])
        elif ch.strip():
            raise ValueError(f"non-kana character {ch!r}")
        i += 1
    return phones


def ja_g2p(text: str) -> Tuple[List[str], List[int], List[int]]:
    try:
        import pyopenjtalk  # type: ignore
        phones_raw = pyopenjtalk.g2p(text).split(' ')
        phones = [p for p in phones_raw if p != 'pau'] or phones_raw
    except ImportError:
        try:
            phones = kana_g2p(text)
        except ValueError as e:
            raise ImportError(
                "Japanese G2P of kanji requires pyopenjtalk (the built-in "
                f"fallback covers kana only: {e})") from e
    phones = ['_'] + phones + ['_']
    tones = [0] * len(phones)
    word2ph = [1] * len(phones)
    return phones, tones, word2ph


def ja_text_normalize(text: str) -> str:
    return text


_LANGUAGE_MODULES = {
    'ZH': (zh_text_normalize, zh_g2p),
    'EN': (en_text_normalize, en_g2p),
    'JA': (ja_text_normalize, ja_g2p),
}


def clean_text(text: str, language: str):
    """normalize + g2p. Parity: text/cleaner.py:9 (only ZH registered there;
    we register ZH/EN/JA, each gated on its dependencies)."""
    normalize, g2p = _LANGUAGE_MODULES[language]
    norm_text = normalize(text)
    phones, tones, word2ph = g2p(norm_text)
    return norm_text, phones, tones, word2ph
