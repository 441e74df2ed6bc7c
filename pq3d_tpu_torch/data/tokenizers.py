"""Tokenizers; counterpart of the synthetic branch of
``pq3d_tpu/data/tokenizers.py``.  The HF CLIP/T5 tokenizers wait until
their files are in the repository, so ``build_tokenizers`` always returns
the synthetic closed-vocabulary bundle (a config that names an HF
tokenizer gets a warning, as the JAX package gives when none is cached)."""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List

log = logging.getLogger(__name__)


class SyntheticTokenize:
    """Picklable synthetic tokenizer: one id per character."""

    def __init__(self, max_length: int = 77):
        self.max_length = max_length

    def __call__(self, s: str) -> List[int]:
        return [ord(c) % 1000 for c in s][: self.max_length]


@dataclasses.dataclass
class TokenizerBundle:
    """Prompt tokenizer (text -> ids), generation tokenizer (response text
    -> ids for T5 teacher forcing) and detokenizer (ids -> text)."""
    tokenize: Callable[[str], List[int]]
    gen_tokenize: Callable[[str], List[int]]
    detokenize: Callable[[object], str]


def build_tokenizers(cfg) -> TokenizerBundle:
    """The synthetic bundle for ``cfg["data_wrapper"]``."""
    from pq3d_tpu_torch.data.unified_datasets import detokenize
    dw = cfg.get("data_wrapper") or {}
    for key in ("tokenizer", "generation_tokenizer"):
        if isinstance(dw, dict) and dw.get(key):
            log.warning("HF tokenizer %r is not available to the port; "
                        "using the synthetic tokenizer: real-data text "
                        "will NOT be in the model's vocab space", dw[key])
    return TokenizerBundle(tokenize=SyntheticTokenize(77),
                           gen_tokenize=SyntheticTokenize(64),
                           detokenize=detokenize)
