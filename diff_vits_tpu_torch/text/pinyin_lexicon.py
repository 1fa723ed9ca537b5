"""Generated pinyin -> phoneme mapping (opencpop-strict conventions).

Instead of shipping a static 429-line lexicon file, the mapping is generated
from the phonological rules of the opencpop-strict convention:

* initial/final split over the standard pinyin initials;
* apical vowels: z/c/s + i -> i0, zh/ch/sh/r + i -> ir;
* j/q/x (and written v-finals) use v for the umlaut vowel;
* zero-initial syllables keep a glide consonant: y-/w- rows strip the glide
  into a 'y'/'w' phone (ye -> y E, yan -> y En);
* bare vowels get the AA/EE/OO onset symbols (a -> AA a, e -> EE e, ...).

``build_lexicon()`` returns the full syllable table; a golden test checks it
reproduces the reference's ``text/opencpop-strict.txt`` exactly.
"""
from __future__ import annotations

from typing import Dict, List

INITIALS = [
    'zh', 'ch', 'sh', 'b', 'p', 'm', 'f', 'd', 't', 'n', 'l', 'g', 'k', 'h',
    'j', 'q', 'x', 'r', 'z', 'c', 's',
]

# finals that can follow a real initial (written pinyin form, v = umlaut u)
_FINALS = [
    'a', 'o', 'e', 'i', 'u', 'v', 'ai', 'ei', 'ui', 'ao', 'ou', 'iu', 'ie',
    've', 'er', 'an', 'en', 'in', 'un', 'vn', 'ang', 'eng', 'ing', 'ong',
    'ia', 'iao', 'ian', 'iang', 'iong', 'ua', 'uo', 'uai', 'uan', 'uang',
    'E', 'En', 'ueng',
]

# which initial+final combinations exist in Mandarin (from the standard
# pinyin syllable chart)
_VALID = {
    'b': 'a o ai ei ao ou an en ang eng i ie iao ian in ing u',
    'p': 'a o ai ei ao ou an en ang eng i ie iao ian in ing u',
    'm': 'a o e ai ei ao ou an en ang eng i ie iao iu ian in ing u',
    'f': 'a o ei ou an en ang eng u',
    'd': 'a e ai ei ao ou an en ang eng i ia ie iao iu ian ing u uo ui uan un ong',
    't': 'a e ai ei ao ou an ang eng i ie iao ian ing u uo ui uan un ong',
    'n': 'a e ai ei ao ou an en ang eng i ie iao iu ian in iang ing u uo uan un ong v ve',
    'l': 'a o e ai ei ao ou an ang eng i ia ie iao iu ian in iang ing u uo uan un ong v ve',
    'g': 'a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong',
    'k': 'a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong',
    'h': 'a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong',
    'j': 'i ia ie iao iu ian in iang ing iong u ue uan un',
    'q': 'i ia ie iao iu ian in iang ing iong u ue uan un',
    'x': 'i ia ie iao iu ian in iang ing iong u ue uan un',
    'zh': 'a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong',
    'ch': 'a e i ai ao ou an en ang eng u ua uo uai ui uan un uang ong',
    'sh': 'a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang',
    'r': 'e i ao ou an en ang eng u ua uo ui uan un uang ong',
    'z': 'a e i ai ei ao ou an en ang eng u uo ui uan un ong',
    'c': 'a e i ai ei ao ou an en ang eng u uo ui uan un ong',
    's': 'a e i ai ao ou an en ang eng u uo ui uan un ong',
}

# zero-initial syllables: written form -> (onset phone, final phone)
_Y_ROWS = {
    'yi': 'i', 'ya': 'a', 'ye': 'E', 'yao': 'ao', 'you': 'ou', 'yan': 'En',
    'yin': 'in', 'yang': 'ang', 'ying': 'ing', 'yong': 'ong', 'yo': 'o',
    'yu': 'v', 'yue': 've', 'yuan': 'van', 'yun': 'vn',
}
_W_ROWS = {
    'wu': 'u', 'wa': 'a', 'wo': 'o', 'wai': 'ai', 'wei': 'ei', 'wan': 'an',
    'wen': 'en', 'wang': 'ang', 'weng': 'eng',
}
_BARE_VOWELS = {
    'a': 'AA a', 'ai': 'AA ai', 'an': 'AA an', 'ang': 'AA ang', 'ao': 'AA ao',
    'e': 'EE e', 'ei': 'EE ei', 'en': 'EE en', 'eng': 'EE eng', 'er': 'EE er',
    'o': 'OO o', 'ou': 'OO ou',
}


def build_lexicon() -> Dict[str, List[str]]:
    lex: Dict[str, List[str]] = {}
    for ini, finals in _VALID.items():
        for fin in finals.split():
            written = ini + fin
            phone_fin = fin
            if fin == 'i' and ini in ('z', 'c', 's'):
                phone_fin = 'i0'
            elif fin == 'i' and ini in ('zh', 'ch', 'sh', 'r'):
                phone_fin = 'ir'
            elif ini in ('j', 'q', 'x'):
                phone_fin = {'u': 'v', 'ue': 've', 'uan': 'van',
                             'un': 'vn'}.get(fin, fin)
            lex[written] = [ini, phone_fin]
    # explicit v-spellings (pypinyin FINALS style writes the umlaut as v)
    for ini in ('j', 'q', 'x'):
        for fin in ('v', 've', 'van', 'vn'):
            lex[ini + fin] = [ini, fin]
    for written, fin in _Y_ROWS.items():
        lex[written] = ['y', fin]
    for fin in ('v', 've', 'van', 'vn'):
        lex['y' + fin] = ['y', fin]
    for written, fin in _W_ROWS.items():
        lex[written] = ['w', fin]
    for written, phones in _BARE_VOWELS.items():
        lex[written] = phones.split(' ')
    return lex
