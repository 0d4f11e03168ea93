"""Whisper language registry — a copy of ``wis_tpu/languages.py``.

The 100 language codes Whisper was trained on, plus natural-name aliases,
used to normalize per-request ``force_language``. Carried as a copy (not
imported) so the port never loads the ``wis_tpu`` package; a CPU test
holds the tables equal to ``wis_tpu.languages``.
"""

from __future__ import annotations

_TABLE = """
en:english zh:chinese de:german es:spanish ru:russian ko:korean fr:french
ja:japanese pt:portuguese tr:turkish pl:polish ca:catalan nl:dutch ar:arabic
sv:swedish it:italian id:indonesian hi:hindi fi:finnish vi:vietnamese
he:hebrew uk:ukrainian el:greek ms:malay cs:czech ro:romanian da:danish
hu:hungarian ta:tamil no:norwegian th:thai ur:urdu hr:croatian bg:bulgarian
lt:lithuanian la:latin mi:maori ml:malayalam cy:welsh sk:slovak te:telugu
fa:persian lv:latvian bn:bengali sr:serbian az:azerbaijani sl:slovenian
kn:kannada et:estonian mk:macedonian br:breton eu:basque is:icelandic
hy:armenian ne:nepali mn:mongolian bs:bosnian kk:kazakh sq:albanian
sw:swahili gl:galician mr:marathi pa:punjabi si:sinhala km:khmer sn:shona
yo:yoruba so:somali af:afrikaans oc:occitan ka:georgian be:belarusian
tg:tajik sd:sindhi gu:gujarati am:amharic yi:yiddish lo:lao uz:uzbek
fo:faroese ht:haitian_creole ps:pashto tk:turkmen nn:nynorsk mt:maltese
sa:sanskrit lb:luxembourgish my:myanmar bo:tibetan tl:tagalog mg:malagasy
as:assamese tt:tatar haw:hawaiian ln:lingala ha:hausa ba:bashkir jw:javanese
su:sundanese
"""

#: code -> canonical lowercase language name
LANGUAGES: dict = {}
for _entry in _TABLE.split():
    _code, _name = _entry.split(":")
    LANGUAGES[_code] = _name.replace("_", " ")

#: languages only representable on v3-layout models (<|yue|> is language
#: token #100, added by large-v3; v2 prompts fall back to <|en|>)
EXTRA_V3_LANGUAGES: dict = {"yue": "cantonese"}

#: language name (and alias) -> code
TO_LANGUAGE_CODE: dict = {name: code for code, name in LANGUAGES.items()}
TO_LANGUAGE_CODE.update(
    {
        "burmese": "my",
        "valencian": "ca",
        "flemish": "nl",
        "haitian": "ht",
        "letzeburgesch": "lb",
        "pushto": "ps",
        "panjabi": "pa",
        "moldavian": "ro",
        "moldovan": "ro",
        "sinhalese": "si",
        "castilian": "es",
        "cantonese": "yue",
    }
)


def check_language(language: str) -> bool:
    """Validate a user-supplied language code or name."""
    if not language:
        return False
    lang = language.strip().lower()
    return (
        lang in LANGUAGES or lang in TO_LANGUAGE_CODE or lang in EXTRA_V3_LANGUAGES
    )


def to_language_code(language: str) -> str:
    """Normalize a code or natural name to a Whisper language code."""
    lang = language.strip().lower()
    if lang in LANGUAGES or lang in EXTRA_V3_LANGUAGES:
        return lang
    if lang in TO_LANGUAGE_CODE:
        return TO_LANGUAGE_CODE[lang]
    raise ValueError(f"Unknown language: {language!r}")
