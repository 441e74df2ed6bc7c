"""Tokenizer wiring: HF CLIP/T5 tokenizers when their files are on this
host, the synthetic closed-vocabulary tokenizer otherwise; counterpart of
``pq3d_tpu/data/tokenizers.py``.

The config keys ``data_wrapper.tokenizer`` / ``data_wrapper.
generation_tokenizer`` name HF tokenizers.  The port loads them with
``local_files_only=True``: from a local directory or the HF cache, never
over the network (the JAX package lets ``from_pretrained`` download).  A
name that cannot load warns, as the JAX package warns, and falls back to
the synthetic tokenizer so the full stack still runs.  ``transformers`` is
imported only when a name is loaded: it is an optional dependency.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

import numpy as np

log = logging.getLogger(__name__)


class SyntheticTokenize:
    """Picklable synthetic tokenizer: one id per character (spawn-pool
    workers pickle the dataset, so tokenizer callables must round-trip
    through pickle)."""

    def __init__(self, max_length: int = 77):
        self.max_length = max_length

    def __call__(self, s: str) -> List[int]:
        return [ord(c) % 1000 for c in s][: self.max_length]


def _from_pretrained(name: str):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(name, local_files_only=True)


class HFTokenize:
    """Picklable HF tokenizer wrapper: pickles by name, reloads lazily in
    the worker process."""

    def __init__(self, name: str, max_length: int):
        self.name = name
        self.max_length = max_length
        self._t = None

    def _tok(self):
        if self._t is None:
            self._t = _from_pretrained(self.name)
        return self._t

    def __call__(self, s: str) -> List[int]:
        return list(self._tok()(s, truncation=True,
                                max_length=self.max_length).input_ids)

    def __getstate__(self):
        return {"name": self.name, "max_length": self.max_length}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._t = None


class HFDetokenize:
    """Picklable ids -> text decoder for the generation tokenizer; ids <= 0
    (PAD) are dropped."""

    def __init__(self, name: str):
        self.name = name
        self._t = None

    def __call__(self, ids) -> str:
        if self._t is None:
            self._t = _from_pretrained(self.name)
        ids = [int(i) for i in np.asarray(ids).tolist() if int(i) > 0]
        return self._t.decode(ids, skip_special_tokens=True)

    def __getstate__(self):
        return {"name": self.name}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._t = None


@dataclasses.dataclass
class TokenizerBundle:
    """Prompt tokenizer (text -> ids), generation tokenizer (response text
    -> ids for T5 teacher forcing) and detokenizer (ids -> text), with the
    names they were loaded from ("synthetic" for the fallback)."""
    tokenize: Callable[[str], List[int]]
    gen_tokenize: Callable[[str], List[int]]
    detokenize: Callable[[object], str]
    prompt_name: str = "synthetic"
    gen_name: str = "synthetic"

    @property
    def is_real(self) -> bool:
        return self.prompt_name != "synthetic" and self.gen_name != "synthetic"


def _load_hf(name: Optional[str]):
    if not name:
        return None
    try:
        return _from_pretrained(str(name))
    except Exception as e:  # not on this host, a bad name, no transformers
        log.warning("HF tokenizer %r unavailable (%s: %s) — falling back to "
                    "the synthetic tokenizer; real-data text will NOT be in "
                    "the model's vocab space", name, type(e).__name__,
                    str(e)[:120])
        return None


def build_tokenizers(cfg) -> TokenizerBundle:
    """Resolve the tokenizers of ``cfg["data_wrapper"]``."""
    dw = cfg.get("data_wrapper") or {}
    prompt_name = dw.get("tokenizer") if hasattr(dw, "get") else None
    gen_name = dw.get("generation_tokenizer") if hasattr(dw, "get") else None

    prompt_tok = _load_hf(prompt_name)
    gen_tok = _load_hf(gen_name)

    if prompt_tok is not None:
        tokenize = HFTokenize(str(prompt_name), max_length=77)
        tokenize._t = prompt_tok
        p_name = str(prompt_name)
    else:
        tokenize, p_name = SyntheticTokenize(77), "synthetic"

    if gen_tok is not None:
        gen_tokenize = HFTokenize(str(gen_name), max_length=64)
        gen_tokenize._t = gen_tok
        detokenize = HFDetokenize(str(gen_name))
        detokenize._t = gen_tok
        g_name = str(gen_name)
    else:
        from pq3d_tpu_torch.data.unified_datasets import detokenize
        gen_tokenize, g_name = SyntheticTokenize(64), "synthetic"

    return TokenizerBundle(tokenize=tokenize, gen_tokenize=gen_tokenize,
                           detokenize=detokenize, prompt_name=p_name,
                           gen_name=g_name)
