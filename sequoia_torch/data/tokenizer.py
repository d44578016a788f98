"""Offline byte-level tokenizer (the port's copy of
`sequoia_tpu/data/tokenizer.py`).

The reference loads the target's HF tokenizer from the hub for its chat
runners (`tests/run_sequoia.py`). Without a network the chat path still
needs some text <-> ids mapping: this maps UTF-8 bytes to ids `3..258`
(0/1/2 are pad/bos/eos, the Llama convention) and back. It is
deterministic, lossless for any text, needs no assets, and offers the two
entry points the chat CLI uses of an HF tokenizer: `__call__` ->
`{"input_ids": [...]}` and `decode(ids, skip_special_tokens=True)`.

Sequences are ~4x a real BPE tokenizer's, so per-prompt token counts are
not comparable to reference runs; accepted tokens per step and ms per
token are per token and stay meaningful.
"""

from __future__ import annotations

from typing import Iterable, List

_OFFSET = 3  # 0 pad / 1 bos / 2 eos


class ByteTokenizer:
    """Minimal HF-tokenizer-compatible byte codec (offline)."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, add_bos: bool = True) -> None:
        self.add_bos = add_bos

    def __call__(self, text: str) -> dict:
        ids = [b + _OFFSET for b in text.encode("utf-8")]
        if self.add_bos:
            ids = [self.bos_token_id] + ids
        return {"input_ids": ids}

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i - _OFFSET for i in ids if _OFFSET <= int(i) < _OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.decode([i]) or f"<{int(i)}>" for i in ids]
