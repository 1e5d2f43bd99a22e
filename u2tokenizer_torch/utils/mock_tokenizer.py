"""Whitespace mock tokenizer with an HF-compatible surface (a copy of
``u2tokenizer_tpu/utils/mock_tokenizer.py``).

Used by ``chip_smoke.py`` and the tests to run the report path without a
downloaded tokenizer. Handles the `<im_patch>` special token the same way the
real tokenizers do after `initialize_vision_tokenizer` adds it
(reference src/model/u2_arch.py:119-133, train_stage1.py:334).
"""

from __future__ import annotations

from typing import Dict, List


class MockTokenizer:
    pad_token_id = 0
    eos_token_id = 1

    def __init__(self):
        self.vocab: Dict[str, int] = {"<pad>": 0, "</s>": 1, "<im_patch>": 2}
        self._inv: Dict[int, str] = {0: "<pad>", 1: "</s>", 2: "<im_patch>"}

    def __len__(self):
        return max(len(self.vocab), 512)

    def _id(self, w: str) -> int:
        if w not in self.vocab:
            idx = len(self.vocab)
            self.vocab[w] = idx
            self._inv[idx] = w
        return self.vocab[w]

    def _split(self, text: str) -> List[str]:
        words: List[str] = []
        rest = text
        while "<im_patch>" in rest:
            pre, rest = rest.split("<im_patch>", 1)
            words.extend(pre.split())
            words.append("<im_patch>")
        words.extend(rest.split())
        return words

    def __call__(self, text: str, add_special_tokens: bool = False, **kw):
        return {"input_ids": [self._id(w) for w in self._split(text)]}

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self(text)["input_ids"]

    def convert_tokens_to_ids(self, tokens):
        """HF surface used by the seg evaluation ('[SEG]' lookup)."""
        if isinstance(tokens, str):
            return self._id(tokens)
        return [self._id(t) for t in tokens]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            w = self._inv.get(int(i), "<unk>")
            if skip_special_tokens and w in ("<pad>", "</s>", "<im_patch>"):
                continue
            words.append(w)
        return " ".join(words)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def apply_chat_template(self, messages, tokenize: bool = False,
                            add_generation_prompt: bool = True) -> str:
        parts = []
        for m in messages:
            parts.append(f"<{m['role']}> {m['content']}")
        if add_generation_prompt:
            parts.append("<assistant>")
        return " ".join(parts)
