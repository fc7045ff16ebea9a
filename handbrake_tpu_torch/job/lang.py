"""ISO-639 language table for track selection (lang.c analog)."""
from __future__ import annotations

# (english name, iso639-1, iso639-2/B, iso639-2/T)
LANGUAGES = [
    ("Any", "", "und", "und"), ("Afrikaans", "af", "afr", "afr"),
    ("Albanian", "sq", "alb", "sqi"), ("Amharic", "am", "amh", "amh"),
    ("Arabic", "ar", "ara", "ara"), ("Armenian", "hy", "arm", "hye"),
    ("Basque", "eu", "baq", "eus"), ("Belarusian", "be", "bel", "bel"),
    ("Bengali", "bn", "ben", "ben"), ("Bosnian", "bs", "bos", "bos"),
    ("Bulgarian", "bg", "bul", "bul"), ("Burmese", "my", "bur", "mya"),
    ("Catalan", "ca", "cat", "cat"), ("Chinese", "zh", "chi", "zho"),
    ("Croatian", "hr", "hrv", "hrv"), ("Czech", "cs", "cze", "ces"),
    ("Danish", "da", "dan", "dan"), ("Dutch", "nl", "dut", "nld"),
    ("English", "en", "eng", "eng"), ("Estonian", "et", "est", "est"),
    ("Filipino", "fil", "fil", "fil"), ("Finnish", "fi", "fin", "fin"),
    ("French", "fr", "fre", "fra"), ("Galician", "gl", "glg", "glg"),
    ("Georgian", "ka", "geo", "kat"), ("German", "de", "ger", "deu"),
    ("Greek", "el", "gre", "ell"), ("Gujarati", "gu", "guj", "guj"),
    ("Hebrew", "he", "heb", "heb"), ("Hindi", "hi", "hin", "hin"),
    ("Hungarian", "hu", "hun", "hun"), ("Icelandic", "is", "ice", "isl"),
    ("Indonesian", "id", "ind", "ind"), ("Irish", "ga", "gle", "gle"),
    ("Italian", "it", "ita", "ita"), ("Japanese", "ja", "jpn", "jpn"),
    ("Kannada", "kn", "kan", "kan"), ("Kazakh", "kk", "kaz", "kaz"),
    ("Khmer", "km", "khm", "khm"), ("Korean", "ko", "kor", "kor"),
    ("Lao", "lo", "lao", "lao"), ("Latvian", "lv", "lav", "lav"),
    ("Lithuanian", "lt", "lit", "lit"), ("Macedonian", "mk", "mac", "mkd"),
    ("Malay", "ms", "may", "msa"), ("Malayalam", "ml", "mal", "mal"),
    ("Maltese", "mt", "mlt", "mlt"), ("Marathi", "mr", "mar", "mar"),
    ("Mongolian", "mn", "mon", "mon"), ("Nepali", "ne", "nep", "nep"),
    ("Norwegian", "no", "nor", "nor"), ("Pashto", "ps", "pus", "pus"),
    ("Persian", "fa", "per", "fas"), ("Polish", "pl", "pol", "pol"),
    ("Portuguese", "pt", "por", "por"), ("Punjabi", "pa", "pan", "pan"),
    ("Romanian", "ro", "rum", "ron"), ("Russian", "ru", "rus", "rus"),
    ("Serbian", "sr", "srp", "srp"), ("Sinhala", "si", "sin", "sin"),
    ("Slovak", "sk", "slo", "slk"), ("Slovenian", "sl", "slv", "slv"),
    ("Spanish", "es", "spa", "spa"), ("Swahili", "sw", "swa", "swa"),
    ("Swedish", "sv", "swe", "swe"), ("Tamil", "ta", "tam", "tam"),
    ("Telugu", "te", "tel", "tel"), ("Thai", "th", "tha", "tha"),
    ("Turkish", "tr", "tur", "tur"), ("Ukrainian", "uk", "ukr", "ukr"),
    ("Urdu", "ur", "urd", "urd"), ("Uzbek", "uz", "uzb", "uzb"),
    ("Vietnamese", "vi", "vie", "vie"), ("Welsh", "cy", "wel", "cym"),
    ("Yiddish", "yi", "yid", "yid"), ("Zulu", "zu", "zul", "zul"),
    ("Unknown", "", "und", "und"),
]

_BY_ANY = {}
for _name, _a1, _a2b, _a2t in LANGUAGES:
    for key in (_name.lower(), _a1, _a2b, _a2t):
        if key and key not in _BY_ANY:
            _BY_ANY[key] = (_name, _a1, _a2b, _a2t)


def lookup(code_or_name: str):
    """Return (name, iso639_1, iso639_2b, iso639_2t) or Unknown."""
    return _BY_ANY.get(code_or_name.strip().lower(), LANGUAGES[-1])


def to_iso639_2(code_or_name: str) -> str:
    return lookup(code_or_name)[2]
