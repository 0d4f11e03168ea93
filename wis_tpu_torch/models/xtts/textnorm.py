"""XTTS text preprocessing (the cleaner stage in front of the BPE).

The reference's TTS server delegates tokenization to Coqui-TTS, whose
VoiceBpeTokenizer runs `preprocess_text` before BPE encoding
(reference xtts/main.py:147-156 calls model.inference_stream, which
tokenizes internally): quotes stripped, lowercase, numbers expanded to
words, abbreviations expanded, symbols spoken, whitespace collapsed.
Skipping that stage feeds digit/symbol characters to a model that was
trained almost entirely on cleaned text — real checkpoints mispronounce
or drop them. This module re-implements the contract from scratch:

- number → words: full cardinal/decimal/currency support for en, es,
  fr, de, it, pt, pl, ru, nl, tr, cs (each written from the standard
  grammar of its language, not ported; English additionally expands
  ordinals; Turkish speaks the percent sign before the number); the
  remaining XTTS languages (ar, zh-cn, hu, ko, ja) pass digits through
  unchanged (the BPE still encodes them — degraded, never
  wrong-language words).
- abbreviation and symbol tables per covered language; Slavic
  one/few/many plural agreement for pl/ru/cs currency units.
- Turkish dotted-İ lowering, quote stripping, whitespace collapse for
  every language.

`preprocess_text(text, lang)` is the only public entry point.

A copy of ``wis_tpu/models/xtts/textnorm.py`` (the port cannot import
``wis_tpu``), held equal by tests/test_torch_xtts.py except for one repair:
the English thousands-group comma is stripped only for English. The JAX
package strips it for every language before reading continental decimal
commas, so ``expand_numbers("3,141", "de")`` says "dreitausend..." there
and "drei komma eins vier eins" here.
"""

from __future__ import annotations

import re

# --------------------------------------------------------------------------- #
# English numbers
# --------------------------------------------------------------------------- #

_EN_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_EN_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand")]

_EN_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _en_under_1000(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(_EN_UNITS[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        t = _EN_TENS[n // 10]
        parts.append(t + ("-" + _EN_UNITS[n % 10] if n % 10 else ""))
    elif n > 0 or not parts:
        parts.append(_EN_UNITS[n])
    return " ".join(parts)


def num_en(n: int) -> str:
    if n < 0:
        return "minus " + num_en(-n)
    if n == 0:
        return "zero"
    parts = []
    for scale, name in _EN_SCALES:
        if n >= scale:
            parts.append(_en_under_1000(n // scale) + " " + name)
            n %= scale
    if n:
        parts.append(_en_under_1000(n))
    return " ".join(parts)


def ord_en(n: int) -> str:
    words = num_en(n)
    head, _, last = words.rpartition(" ")
    if "-" in last:
        tens, _, unit = last.rpartition("-")
        last = tens + "-" + _EN_ORD_IRREGULAR.get(unit, unit + "th")
    elif last in _EN_ORD_IRREGULAR:
        last = _EN_ORD_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    elif last.endswith("t"):  # eight handled above; hundred/thousand end 'd'
        last = last + "h"
    else:
        last = last + "th"
    return (head + " " + last).strip()


# --------------------------------------------------------------------------- #
# Spanish numbers
# --------------------------------------------------------------------------- #

_ES_UNITS = [
    "cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete", "ocho",
    "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
    "dieciséis", "diecisiete", "dieciocho", "diecinueve", "veinte",
    "veintiuno", "veintidós", "veintitrés", "veinticuatro", "veinticinco",
    "veintiséis", "veintisiete", "veintiocho", "veintinueve",
]
_ES_TENS = [
    "", "", "", "treinta", "cuarenta", "cincuenta", "sesenta", "setenta",
    "ochenta", "noventa",
]
_ES_HUNDREDS = [
    "", "ciento", "doscientos", "trescientos", "cuatrocientos",
    "quinientos", "seiscientos", "setecientos", "ochocientos",
    "novecientos",
]


def _es_under_1000(n: int) -> str:
    if n == 100:
        return "cien"
    parts = []
    if n >= 100:
        parts.append(_ES_HUNDREDS[n // 100])
        n %= 100
    if n >= 30:
        t = _ES_TENS[n // 10]
        parts.append(t + (" y " + _ES_UNITS[n % 10] if n % 10 else ""))
    elif n > 0 or not parts:
        parts.append(_ES_UNITS[n])
    return " ".join(p for p in parts if p)


def num_es(n: int) -> str:
    if n < 0:
        return "menos " + num_es(-n)
    if n == 0:
        return "cero"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append("un millón" if m == 1 else num_es(m) + " millones")
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append("mil" if k == 1 else _es_under_1000(k) + " mil")
        n %= 1000
    if n:
        parts.append(_es_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# French numbers
# --------------------------------------------------------------------------- #

_FR_UNITS = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
    "dix-sept", "dix-huit", "dix-neuf",
]
_FR_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante",
            60: "soixante", 80: "quatre-vingt"}


def _fr_under_100(n: int) -> str:
    if n < 20:
        return _FR_UNITS[n]
    if n < 70:
        t, u = (n // 10) * 10, n % 10
        if u == 0:
            return _FR_TENS[t]
        if u == 1:
            return _FR_TENS[t] + " et un"
        return _FR_TENS[t] + "-" + _FR_UNITS[u]
    if n < 80:  # soixante-dix .. soixante-dix-neuf
        if n == 71:
            return "soixante et onze"
        return "soixante-" + _FR_UNITS[n - 60]
    # 80-99: quatre-vingt(s) + 0..19
    u = n - 80
    if u == 0:
        return "quatre-vingts"
    return "quatre-vingt-" + _FR_UNITS[u]


def _fr_under_1000(n: int) -> str:
    parts = []
    if n >= 100:
        h = n // 100
        if h == 1:
            parts.append("cent")
        else:
            parts.append(_FR_UNITS[h] + " cent" + ("s" if n % 100 == 0 else ""))
        n %= 100
    if n or not parts:
        parts.append(_fr_under_100(n))
    return " ".join(parts)


def num_fr(n: int) -> str:
    if n < 0:
        return "moins " + num_fr(-n)
    if n == 0:
        return "zéro"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append(("un million" if m == 1 else num_fr(m) + " millions"))
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append("mille" if k == 1 else _fr_under_1000(k) + " mille")
        n %= 1000
    if n:
        parts.append(_fr_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# German numbers
# --------------------------------------------------------------------------- #

_DE_UNITS = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
    "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
    "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_TENS = [
    "", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
    "siebzig", "achtzig", "neunzig",
]


def _de_unit_prefix(u: int) -> str:
    # "ein" (not "eins") when compounded: einundzwanzig, einhundert
    return "ein" if u == 1 else _DE_UNITS[u]


def _de_under_1000(n: int) -> str:
    parts = ""
    if n >= 100:
        parts += _de_unit_prefix(n // 100) + "hundert"
        n %= 100
    if n >= 20:
        u = n % 10
        if u:
            parts += _de_unit_prefix(u) + "und"
        parts += _DE_TENS[n // 10]
    elif n > 0:
        parts += _DE_UNITS[n] if parts == "" else (
            "eins" if n == 1 else _DE_UNITS[n]
        )
    return parts or _DE_UNITS[0]


def num_de(n: int) -> str:
    if n < 0:
        return "minus " + num_de(-n)
    if n == 0:
        return "null"
    parts = ""
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts += ("eine Million " if m == 1 else num_de(m) + " Millionen ")
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts += ("eintausend" if k == 1 else _de_under_1000(k) + "tausend")
        n %= 1000
    if n:
        parts += _de_under_1000(n)
    return parts.strip().lower()


# --------------------------------------------------------------------------- #
# Italian numbers
# --------------------------------------------------------------------------- #

_IT_UNITS = [
    "zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette",
    "otto", "nove", "dieci", "undici", "dodici", "tredici", "quattordici",
    "quindici", "sedici", "diciassette", "diciotto", "diciannove",
]
_IT_TENS = [
    "", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
    "settanta", "ottanta", "novanta",
]


def _it_under_100(n: int) -> str:
    if n < 20:
        return _IT_UNITS[n]
    t, u = n // 10, n % 10
    tens = _IT_TENS[t]
    if u == 0:
        return tens
    if u in (1, 8):  # vowel elision: ventuno, ventotto
        tens = tens[:-1]
    return tens + ("tré" if u == 3 else _IT_UNITS[u])


def _it_under_1000(n: int) -> str:
    if n < 100:
        return _it_under_100(n)
    h, r = n // 100, n % 100
    word = "cento" if h == 1 else _IT_UNITS[h] + "cento"
    if r == 0:
        return word
    rest = _it_under_100(r)
    if rest.startswith("o"):  # centottanta, centotto
        word = word[:-1]
    return word + rest


def num_it(n: int) -> str:
    if n < 0:
        return "meno " + num_it(-n)
    if n == 0:
        return "zero"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append("un milione" if m == 1 else num_it(m) + " milioni")
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append("mille" if k == 1 else _it_under_1000(k) + "mila")
        n %= 1000
    if n:
        parts.append(_it_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# Portuguese numbers (Brazilian forms: dezesseis, catorze, milhão)
# --------------------------------------------------------------------------- #

_PT_UNITS = [
    "zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete",
    "oito", "nove", "dez", "onze", "doze", "treze", "catorze", "quinze",
    "dezesseis", "dezessete", "dezoito", "dezenove",
]
_PT_TENS = [
    "", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta",
    "setenta", "oitenta", "noventa",
]
_PT_HUNDREDS = [
    "", "cento", "duzentos", "trezentos", "quatrocentos", "quinhentos",
    "seiscentos", "setecentos", "oitocentos", "novecentos",
]


def _pt_under_1000(n: int) -> str:
    if n == 100:
        return "cem"
    parts = []
    if n >= 100:
        parts.append(_PT_HUNDREDS[n // 100])
        n %= 100
    if n >= 20:
        u = n % 10
        parts.append(_PT_TENS[n // 10] + (" e " + _PT_UNITS[u] if u else ""))
    elif n > 0 or not parts:
        parts.append(_PT_UNITS[n])
    return " e ".join(parts)


def num_pt(n: int) -> str:
    if n < 0:
        return "menos " + num_pt(-n)
    if n == 0:
        return "zero"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append("um milhão" if m == 1 else num_pt(m) + " milhões")
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append("mil" if k == 1 else _pt_under_1000(k) + " mil")
        n %= 1000
    if n:
        last = _pt_under_1000(n)
        # "e" links thousands to a final group under 100 or an exact
        # hundred (mil e cinco; dois mil e duzentos) but not otherwise
        if parts and (n < 100 or n % 100 == 0):
            parts[-1] = parts[-1] + " e " + last
        else:
            parts.append(last)
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# Polish numbers (one/few/many plural agreement for group words)
# --------------------------------------------------------------------------- #

_PL_UNITS = [
    "zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć", "siedem",
    "osiem", "dziewięć", "dziesięć", "jedenaście", "dwanaście",
    "trzynaście", "czternaście", "piętnaście", "szesnaście",
    "siedemnaście", "osiemnaście", "dziewiętnaście",
]
_PL_TENS = [
    "", "", "dwadzieścia", "trzydzieści", "czterdzieści", "pięćdziesiąt",
    "sześćdziesiąt", "siedemdziesiąt", "osiemdziesiąt",
    "dziewięćdziesiąt",
]
_PL_HUNDREDS = [
    "", "sto", "dwieście", "trzysta", "czterysta", "pięćset", "sześćset",
    "siedemset", "osiemset", "dziewięćset",
]


def _slavic_form(n: int, forms) -> str:
    """Slavic one/few/many plural selection (pl/ru share the rule):
    1 (but not 11) → singular; 2-4 (but not 12-14) → paucal; else
    genitive plural."""
    if n % 10 == 1 and n % 100 != 11:
        return forms[0]
    if 2 <= n % 10 <= 4 and not 12 <= n % 100 <= 14:
        return forms[1]
    return forms[2]


def _pl_under_1000(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(_PL_HUNDREDS[n // 100])
        n %= 100
    if n >= 20:
        parts.append(_PL_TENS[n // 10])
        if n % 10:
            parts.append(_PL_UNITS[n % 10])
    elif n > 0 or not parts:
        parts.append(_PL_UNITS[n])
    return " ".join(parts)


def num_pl(n: int) -> str:
    if n < 0:
        return "minus " + num_pl(-n)
    if n == 0:
        return "zero"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        word = _slavic_form(m, ("milion", "miliony", "milionów"))
        parts.append(word if m == 1 else num_pl(m) + " " + word)
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        word = _slavic_form(k, ("tysiąc", "tysiące", "tysięcy"))
        parts.append(word if k == 1 else _pl_under_1000(k) + " " + word)
        n %= 1000
    if n:
        parts.append(_pl_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# Russian numbers (feminine agreement with тысяча; one/few/many groups)
# --------------------------------------------------------------------------- #

_RU_UNITS = [
    "ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
    "восемь", "девять", "десять", "одиннадцать", "двенадцать",
    "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
    "семнадцать", "восемнадцать", "девятнадцать",
]
_RU_TENS = [
    "", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят",
    "семьдесят", "восемьдесят", "девяносто",
]
_RU_HUNDREDS = [
    "", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот",
    "семьсот", "восемьсот", "девятьсот",
]


def _ru_under_1000(n: int, feminine: bool = False) -> str:
    parts = []
    if n >= 100:
        parts.append(_RU_HUNDREDS[n // 100])
        n %= 100
    if n >= 20:
        parts.append(_RU_TENS[n // 10])
        n %= 10
    if n > 0 or not parts:
        if feminine and n == 1:
            parts.append("одна")
        elif feminine and n == 2:
            parts.append("две")
        else:
            parts.append(_RU_UNITS[n])
    return " ".join(parts)


def num_ru(n: int) -> str:
    if n < 0:
        return "минус " + num_ru(-n)
    if n == 0:
        return "ноль"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append(
            num_ru(m) + " "
            + _slavic_form(m, ("миллион", "миллиона", "миллионов"))
        )
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append(
            _ru_under_1000(k, feminine=True) + " "
            + _slavic_form(k, ("тысяча", "тысячи", "тысяч"))
        )
        n %= 1000
    if n:
        parts.append(_ru_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# Dutch numbers (unit-before-tens with en/ën liaison)
# --------------------------------------------------------------------------- #

_NL_UNITS = [
    "nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven", "acht",
    "negen", "tien", "elf", "twaalf", "dertien", "veertien", "vijftien",
    "zestien", "zeventien", "achttien", "negentien",
]
_NL_TENS = [
    "", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
    "zeventig", "tachtig", "negentig",
]


def _nl_under_100(n: int) -> str:
    if n < 20:
        return _NL_UNITS[n]
    t, u = n // 10, n % 10
    if u == 0:
        return _NL_TENS[t]
    unit = _NL_UNITS[u]
    link = "ën" if unit.endswith("e") else "en"  # tweeëntwintig
    return unit + link + _NL_TENS[t]


def _nl_under_1000(n: int) -> str:
    if n < 100:
        return _nl_under_100(n)
    h, r = n // 100, n % 100
    word = "honderd" if h == 1 else _NL_UNITS[h] + "honderd"
    return word + (_nl_under_100(r) if r else "")


def num_nl(n: int) -> str:
    if n < 0:
        return "min " + num_nl(-n)
    if n == 0:
        return "nul"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append(("een" if m == 1 else num_nl(m)) + " miljoen")
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append(("" if k == 1 else _nl_under_1000(k)) + "duizend")
        n %= 1000
    if n:
        parts.append(_nl_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# Turkish numbers (strictly positional, space-joined)
# --------------------------------------------------------------------------- #

_TR_UNITS = [
    "sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi", "sekiz",
    "dokuz",
]
_TR_TENS = [
    "", "on", "yirmi", "otuz", "kırk", "elli", "altmış", "yetmiş",
    "seksen", "doksan",
]


def _tr_under_1000(n: int) -> str:
    parts = []
    if n >= 100:
        h = n // 100
        parts.append(("" if h == 1 else _TR_UNITS[h] + " ") + "yüz")
        n %= 100
    if n >= 10:
        parts.append(_TR_TENS[n // 10])
        n %= 10
    if n > 0 or not parts:
        parts.append(_TR_UNITS[n])
    return " ".join(parts)


def num_tr(n: int) -> str:
    if n < 0:
        return "eksi " + num_tr(-n)
    if n == 0:
        return "sıfır"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        parts.append(num_tr(m) + " milyon")
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        parts.append(("" if k == 1 else _tr_under_1000(k) + " ") + "bin")
        n %= 1000
    if n:
        parts.append(_tr_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------------- #
# Czech numbers (one/few/many group agreement, shared Slavic rule)
# --------------------------------------------------------------------------- #

_CS_UNITS = [
    "nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm",
    "osm", "devět", "deset", "jedenáct", "dvanáct", "třináct",
    "čtrnáct", "patnáct", "šestnáct", "sedmnáct", "osmnáct",
    "devatenáct",
]
_CS_TENS = [
    "", "", "dvacet", "třicet", "čtyřicet", "padesát", "šedesát",
    "sedmdesát", "osmdesát", "devadesát",
]
_CS_HUNDREDS = [
    "", "sto", "dvě stě", "tři sta", "čtyři sta", "pět set", "šest set",
    "sedm set", "osm set", "devět set",
]


def _cs_under_1000(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(_CS_HUNDREDS[n // 100])
        n %= 100
    if n >= 20:
        parts.append(_CS_TENS[n // 10])
        n %= 10
    if n > 0 or not parts:
        parts.append(_CS_UNITS[n])
    return " ".join(parts)


def num_cs(n: int) -> str:
    if n < 0:
        return "minus " + num_cs(-n)
    if n == 0:
        return "nula"
    parts = []
    if n >= 10 ** 6:
        m = n // 10 ** 6
        word = _slavic_form(m, ("milion", "miliony", "milionů"))
        parts.append(word if m == 1 else num_cs(m) + " " + word)
        n %= 10 ** 6
    if n >= 1000:
        k = n // 1000
        word = _slavic_form(k, ("tisíc", "tisíce", "tisíc"))
        parts.append(word if k == 1 else _cs_under_1000(k) + " " + word)
        n %= 1000
    if n:
        parts.append(_cs_under_1000(n))
    return " ".join(parts)


_NUM_FN = {
    "en": num_en, "es": num_es, "fr": num_fr, "de": num_de,
    "it": num_it, "pt": num_pt, "pl": num_pl, "ru": num_ru, "nl": num_nl,
    "tr": num_tr, "cs": num_cs,
}

# --------------------------------------------------------------------------- #
# Currency / decimal vocabulary per language
# --------------------------------------------------------------------------- #

# Each symbol maps to (unit_forms, cent_forms): 1 form = invariant,
# 2 forms = singular/plural, 3 forms = Slavic one/few/many (selected by
# _slavic_form — pl/ru unit words agree with the amount).
_CURRENCY = {
    "en": {"$": (("dollar", "dollars"), ("cent", "cents")),
           "£": (("pound", "pounds"), ("penny", "pence")),
           "€": (("euro", "euros"), ("cent", "cents"))},
    "es": {"$": (("dólar", "dólares"), ("centavo", "centavos")),
           "£": (("libra", "libras"), ("penique", "peniques")),
           "€": (("euro", "euros"), ("céntimo", "céntimos"))},
    "fr": {"$": (("dollar", "dollars"), ("centime", "centimes")),
           "£": (("livre", "livres"), ("penny", "pence")),
           "€": (("euro", "euros"), ("centime", "centimes"))},
    "de": {"$": (("dollar",), ("cent",)),
           "£": (("pfund",), ("penny", "pence")),
           "€": (("euro",), ("cent",))},
    "it": {"$": (("dollaro", "dollari"), ("centesimo", "centesimi")),
           "£": (("sterlina", "sterline"), ("penny",)),
           "€": (("euro",), ("centesimo", "centesimi"))},
    "pt": {"$": (("dólar", "dólares"), ("centavo", "centavos")),
           "£": (("libra", "libras"), ("penny", "pence")),
           "€": (("euro", "euros"), ("cêntimo", "cêntimos"))},
    "pl": {"$": (("dolar", "dolary", "dolarów"),
                 ("cent", "centy", "centów")),
           "£": (("funt", "funty", "funtów"),
                 ("pens", "pensy", "pensów")),
           "€": (("euro",), ("cent", "centy", "centów"))},
    "ru": {"$": (("доллар", "доллара", "долларов"),
                 ("цент", "цента", "центов")),
           "£": (("фунт", "фунта", "фунтов"),
                 ("пенс", "пенса", "пенсов")),
           "€": (("евро",), ("цент", "цента", "центов"))},
    "nl": {"$": (("dollar",), ("cent",)),
           "£": (("pond",), ("penny",)),
           "€": (("euro",), ("cent",))},
    "tr": {"$": (("dolar",), ("sent",)),
           "£": (("sterlin",), ("peni",)),
           "€": (("avro",), ("sent",))},
    "cs": {"$": (("dolar", "dolary", "dolarů"),
                 ("cent", "centy", "centů")),
           "£": (("libra", "libry", "liber"), ("pence",)),
           "€": (("euro", "eura", "eur"),
                 ("cent", "centy", "centů"))},
}
_DECIMAL_POINT = {
    "en": "point", "es": "coma", "fr": "virgule", "de": "komma",
    "it": "virgola", "pt": "vírgula", "pl": "przecinek", "ru": "запятая",
    "nl": "komma", "tr": "virgül", "cs": "celá",
}
_AND_WORD = {
    "en": "and", "es": "con", "fr": "et", "de": "und", "it": "e",
    "pt": "e", "pl": "i", "ru": "и", "nl": "en", "tr": "ve", "cs": "a",
}


def _select_form(n: int, forms) -> str:
    if len(forms) == 3:
        return _slavic_form(n, forms)
    if len(forms) == 2:
        return forms[0] if n == 1 else forms[1]
    return forms[0]

# --------------------------------------------------------------------------- #
# Abbreviations (dot-terminated) and spoken symbols
# --------------------------------------------------------------------------- #

_ABBREV = {
    "en": {
        "mrs": "misses", "mr": "mister", "dr": "doctor", "st": "saint",
        "co": "company", "jr": "junior", "ltd": "limited", "col": "colonel",
        "gen": "general", "rev": "reverend", "hon": "honorable",
        "sgt": "sergeant", "capt": "captain", "maj": "major",
        "lt": "lieutenant", "esq": "esquire", "ft": "fort", "etc": "et cetera",
    },
    "es": {
        "sra": "señora", "sr": "señor", "dr": "doctor", "dra": "doctora",
        "srta": "señorita", "av": "avenida", "ud": "usted", "uds": "ustedes",
    },
    "fr": {
        "mme": "madame", "mr": "monsieur", "m": "monsieur", "mlle":
        "mademoiselle", "dr": "docteur", "st": "saint", "av": "avenue",
        "etc": "et cetera",
    },
    "de": {
        "dr": "doktor", "st": "sankt", "nr": "nummer", "str": "straße",
        "prof": "professor", "usw": "und so weiter", "bzw":
        "beziehungsweise", "z.b": "zum beispiel",
    },
    "it": {
        "sig": "signor", "dott": "dottor", "prof": "professor",
        "avv": "avvocato", "ecc": "eccetera", "geom": "geometra",
    },
    "pt": {
        "sr": "senhor", "sra": "senhora", "dr": "doutor", "dra":
        "doutora", "av": "avenida", "etc": "et cetera",
    },
    "pl": {
        "dr": "doktor", "prof": "profesor", "ul": "ulica",
        "np": "na przykład", "itd": "i tak dalej", "tzn": "to znaczy",
    },
    "ru": {
        "т.д": "так далее", "т.е": "то есть", "ул": "улица",
        "гр": "гражданин",
    },
    "nl": {
        "dhr": "de heer", "mevr": "mevrouw", "dr": "dokter",
        "st": "sint", "nr": "nummer", "enz": "enzovoort",
    },
    "tr": {
        "dr": "doktor", "cad": "cadde", "sok": "sokak",
        "vb": "ve benzeri", "vs": "vesaire",
    },
    "cs": {
        "dr": "doktor", "ul": "ulice", "např": "například",
        "atd": "a tak dále", "tzv": "takzvaný",
    },
}

_SYMBOLS = {
    "en": {"&": " and ", "@": " at ", "%": " percent ", "#": " hash ",
           "°": " degrees "},
    "es": {"&": " y ", "@": " arroba ", "%": " por ciento ", "#":
           " numeral ", "°": " grados "},
    "fr": {"&": " et ", "@": " arobase ", "%": " pour cent ", "#":
           " dièse ", "°": " degrés "},
    "de": {"&": " und ", "@": " at ", "%": " prozent ", "#": " raute ",
           "°": " grad "},
    "it": {"&": " e ", "@": " chiocciola ", "%": " per cento ",
           "#": " cancelletto ", "°": " gradi "},
    "pt": {"&": " e ", "@": " arroba ", "%": " por cento ",
           "#": " cardinal ", "°": " graus "},
    "pl": {"&": " i ", "@": " małpa ", "%": " procent ",
           "#": " kratka ", "°": " stopni "},
    "ru": {"&": " и ", "@": " собака ", "%": " процентов ",
           "#": " решётка ", "°": " градусов "},
    "nl": {"&": " en ", "@": " apenstaartje ", "%": " procent ",
           "#": " hekje ", "°": " graden "},
    "tr": {"&": " ve ", "@": " et ", "%": " yüzde ",
           "#": " kare ", "°": " derece "},
    "cs": {"&": " a ", "@": " zavináč ", "%": " procent ",
           "#": " mřížka ", "°": " stupňů "},
}

_WHITESPACE_RE = re.compile(r"\s+")
_NUMBER_RE = re.compile(r"\d+")
_COMMA_GROUP_RE = re.compile(r"(\d),(\d\d\d)(?!\d)")
_DECIMAL_RE = re.compile(r"(\d+)\.(\d+)")
#: continental decimal comma (3,5) — applied for non-English languages
#: AFTER thousand-group commas are stripped, so only true decimals remain
_DECIMAL_COMMA_RE = re.compile(r"(\d+),(\d+)")
_ORDINAL_EN_RE = re.compile(r"\b(\d+)(st|nd|rd|th)\b")
#: amount accepts dot or comma decimals (€2.50 and €2,50 both speak as
#: two euros fifty)
_CURRENCY_RE = re.compile(r"([$£€])(\d+(?:[.,]\d+)?)")


def _expand_currency(m: re.Match, lang: str) -> str:
    sym, amount = m.group(1), m.group(2).replace(",", ".")
    unit_forms, cent_forms = _CURRENCY[lang][sym]
    num = _NUM_FN[lang]
    if "." in amount:
        whole_s, frac_s = amount.split(".")
        whole, cents = int(whole_s or 0), int(frac_s[:2].ljust(2, "0"))
    else:
        whole, cents = int(amount), 0
    parts = []
    if whole or not cents:
        parts.append(num(whole) + " " + _select_form(whole, unit_forms))
    if cents:
        parts.append(num(cents) + " " + _select_form(cents, cent_forms))
    return (" " + _AND_WORD[lang] + " ").join(parts)


def _expand_decimal(m: re.Match, lang: str) -> str:
    num = _NUM_FN[lang]
    digits = " ".join(num(int(d)) for d in m.group(2))
    return num(int(m.group(1))) + " " + _DECIMAL_POINT[lang] + " " + digits


_TR_PERCENT_RE = re.compile(r"%\s*(\d)")


def expand_numbers(text: str, lang: str) -> str:
    """Digits → words for the covered languages; pass-through otherwise."""
    if lang not in _NUM_FN:
        return text
    num = _NUM_FN[lang]
    if lang == "tr":
        # Turkish writes the percent sign BEFORE the number (%50) and
        # speaks it first (yüzde elli) — rewrite before digit expansion
        text = _TR_PERCENT_RE.sub(r"yüzde \1", text)
    if lang == "en":
        # continental languages write the decimal comma: "3,141" is 3.141
        text = _COMMA_GROUP_RE.sub(r"\1\2", text)
    text = _CURRENCY_RE.sub(lambda m: _expand_currency(m, lang), text)
    if lang == "en":
        text = _ORDINAL_EN_RE.sub(lambda m: ord_en(int(m.group(1))), text)
    text = _DECIMAL_RE.sub(lambda m: _expand_decimal(m, lang), text)
    if lang != "en":
        text = _DECIMAL_COMMA_RE.sub(lambda m: _expand_decimal(m, lang), text)
    text = _NUMBER_RE.sub(lambda m: num(int(m.group(0))), text)
    return text


def expand_abbreviations(text: str, lang: str) -> str:
    table = _ABBREV.get(lang)
    if not table:
        return text
    for abbrev, full in table.items():
        text = re.sub(
            r"\b" + re.escape(abbrev) + r"\.", full + " ", text,
            flags=re.IGNORECASE,
        )
    return text


def expand_symbols(text: str, lang: str) -> str:
    table = _SYMBOLS.get(lang)
    if not table:
        return text
    for sym, spoken in table.items():
        text = text.replace(sym, spoken)
    return text


def preprocess_text(text: str, lang: str) -> str:
    """The full cleaner: quote strip → lowercase → numbers →
    abbreviations → symbols → whitespace collapse.

    `lang` is the XTTS language code ("zh-cn" normalizes to "zh" for
    table lookup). Languages without tables degrade gracefully — only
    the language-independent steps apply.
    """
    lang = lang.split("-")[0]
    text = text.replace('"', "")
    if lang == "tr":
        text = text.replace("İ", "i").replace("Ö", "ö").replace("Ü", "ü")
    text = text.lower()
    text = expand_numbers(text, lang)
    text = expand_abbreviations(text, lang)
    text = expand_symbols(text, lang)
    text = _WHITESPACE_RE.sub(" ", text).strip()
    return text
