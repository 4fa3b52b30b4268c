"""Internationalization (port of ``rvc_tpu/ui/i18n.py``).

The reference's assets/i18n/i18n.py:10: ``I18nAuto`` detects the locale
(a configured language overrides it), loads the key -> translation JSON of
that language, and falls through to the key itself. The packs are
``languages/<lang>.json``, byte for byte the JAX package's 60 packs; the
keys are the English UI strings. ``otq_OTQ`` (Queretaro Otomi) carries
English values for most keys, as in the JAX package.
"""

from __future__ import annotations

import json
import locale
import os
from typing import Dict, Optional


class I18nAuto:
    def __init__(
        self,
        language: Optional[str] = None,
        languages_dir: Optional[str] = None,
    ):
        self.languages_dir = languages_dir or os.path.join(
            os.path.dirname(__file__), "languages"
        )
        if language in (None, "", "auto", "Language automatically detected"):
            language = self._detect()
        self.language = language
        self.mapping: Dict[str, str] = self._load(language)

    @staticmethod
    def _detect() -> str:
        try:
            loc = locale.getlocale()[0] or os.environ.get("LANG", "en_US")
        except Exception:
            loc = "en_US"
        return (loc or "en_US").split(".")[0]

    def _load(self, language: str) -> Dict[str, str]:
        prefix = language.split("_")[0]
        # same-language packs under a different region code: several shipped
        # packs use doubled codes (cs_CS, el_EL, uk_UK, he_HE, fa_FA...), so
        # a cs_CZ/el_GR/uk_UA user must still find their translation
        prefix_hits = sorted(
            c for c in self.available_languages()
            if c.split("_")[0] == prefix
        )
        for cand in [language, prefix, *prefix_hits, "en_US"]:
            path = os.path.join(self.languages_dir, f"{cand}.json")
            if os.path.exists(path):
                try:
                    with open(path, encoding="utf-8") as f:
                        return json.load(f)
                except Exception:
                    pass
        return {}

    def __call__(self, key: str) -> str:
        return self.mapping.get(key, key)

    def available_languages(self):
        if not os.path.isdir(self.languages_dir):
            return ["en_US"]
        return sorted(
            f[:-5] for f in os.listdir(self.languages_dir) if f.endswith(".json")
        )
