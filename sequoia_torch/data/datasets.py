"""Data loading (the port's copy of `sequoia_tpu/data/datasets.py`): the
analog of the reference's `data_converter.py` and of the MT-Bench prompt
loading in `tests/run_sequoia.py:284-297`.

Every loader returns a `TokenDataset` of fixed-shape padded token arrays
(`[n, seq_len]` int32 and the true lengths). The offline formats are
pre-tokenized JSONL (c4_small-style), MT-Bench JSONL and a
`datasets.save_to_disk` arrow directory (which needs HF `datasets`,
imported when called). The converters of named hub datasets need HF
`datasets`, a tokenizer and a network or a local cache; they raise a clear
error without them. The data files the repo bundles are read by path
(`sequoia_tpu/data/bundled/`); the port keeps no copy.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TokenDataset:
    """Fixed-shape tokenized prompts: `ids[i, :lengths[i]]` are real tokens,
    the tail is `pad_id`."""

    ids: np.ndarray      # i32 [n, seq_len]
    lengths: np.ndarray  # i32 [n]
    pad_id: int = 0

    def __post_init__(self) -> None:
        self.ids = np.asarray(self.ids, np.int32)
        self.lengths = np.asarray(self.lengths, np.int32)
        if self.ids.ndim != 2 or self.lengths.shape != (self.ids.shape[0],):
            raise ValueError(f"ids {self.ids.shape} and lengths {self.lengths.shape} "
                             "are not [n, seq_len] and [n]")
        if (self.lengths > self.ids.shape[1]).any():
            raise ValueError("a length exceeds seq_len")

    def __len__(self) -> int:
        return self.ids.shape[0]

    @property
    def seq_len(self) -> int:
        return self.ids.shape[1]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.ids[i, : self.lengths[i]]

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]

    def select(self, start: int, end: int) -> "TokenDataset":
        """Range slice: the reference CLIs' `--start/--end` window
        (`tests/testbed.py:27-28`)."""
        return TokenDataset(self.ids[start:end], self.lengths[start:end], self.pad_id)

    @staticmethod
    def from_sequences(seqs: Sequence[Sequence[int]], seq_len: Optional[int] = None,
                       pad_id: int = 0, truncate: bool = True) -> "TokenDataset":
        """Pad a ragged list of token lists to one `[n, seq_len]`."""
        seqs = [np.asarray(s, np.int32).reshape(-1) for s in seqs]
        if seq_len is None:
            seq_len = max((len(s) for s in seqs), default=1)
        ids = np.full((len(seqs), seq_len), pad_id, np.int32)
        lengths = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            if len(s) > seq_len:
                if not truncate:
                    raise ValueError(f"sequence {i} ({len(s)}) exceeds seq_len {seq_len}")
                s = s[:seq_len]
            ids[i, : len(s)] = s
            lengths[i] = len(s)
        return TokenDataset(ids, lengths, pad_id)


# ---------------------------------------------------------------------------
# Offline formats
# ---------------------------------------------------------------------------


def load_pretokenized_jsonl(path: str, seq_len: int = 256, key: str = "input_tokens",
                            pad_id: int = 0, limit: Optional[int] = None) -> TokenDataset:
    """A `dataset/c4_small.json`-style JSONL of pre-tokenized rows
    (`{"input_tokens": [...]}` a line; the reference reads it through
    `load_dataset("json", ...)`, `data_converter.py:52-66`)."""
    seqs: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            seqs.append(np.asarray(json.loads(line)[key], np.int32))
            if limit is not None and len(seqs) >= limit:
                break
    return TokenDataset.from_sequences(seqs, seq_len=seq_len, pad_id=pad_id)


def load_mt_bench_prompts(path: str, turn: int = 0) -> List[str]:
    """An MT-Bench question file (`{"question_id", "category", "turns":
    [...]}` a line). The reference uses `turns[0]` only
    (`tests/run_sequoia.py:295-297`)."""
    prompts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                prompts.append(json.loads(line)["turns"][turn])
    return prompts


def format_inst(prompt: str) -> str:
    """The chat prompt template of every reference chat runner
    (`tests/run_sequoia.py:82`)."""
    return "[INST]" + prompt + "[/INST]" + "\n\nASSISTANT:"


MT_BENCH_URL = (
    "https://raw.githubusercontent.com/lm-sys/FastChat/main/"
    "fastchat/llm_judge/data/mt_bench/question.jsonl"
)
# The repository's bundled data files, read by path: the MT-Bench questions
# and the pre-tokenized c4_small rows (the corpus `tools/distill.py` trains
# on).
BUNDLED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "sequoia_tpu", "data", "bundled")
BUNDLED_MT_BENCH = os.path.join(BUNDLED, "mt_bench.jsonl")
C4_SMALL = os.path.join(BUNDLED, "c4_small.json")


def _fetch(url: str, path: str) -> None:
    import urllib.request

    urllib.request.urlretrieve(url, path)


def ensure_mt_bench(data_root: str) -> str:
    """The local MT-Bench path: `data_root/mt_bench.jsonl` if present, else
    the bundled copy, else a download into `data_root`
    (`tests/run_sequoia.py:284-292`), which raises when it fails."""
    path = os.path.join(data_root, "mt_bench.jsonl")
    if os.path.exists(path):
        return path
    if os.path.exists(BUNDLED_MT_BENCH):
        return BUNDLED_MT_BENCH
    try:
        os.makedirs(data_root, exist_ok=True)
        _fetch(MT_BENCH_URL, path)
        return path
    except OSError as e:   # urllib's URLError / HTTPError included
        raise RuntimeError(
            f"mt_bench.jsonl not found at {path} and download failed ({e}); "
            f"place the FastChat question.jsonl there manually"
        ) from e


# ---------------------------------------------------------------------------
# Tokenizer-backed converters (reference parity; need HF `datasets` and a
# network or a local cache)
# ---------------------------------------------------------------------------


def _tokenize_texts(tokenizer, texts: Sequence[str], seq_len: int) -> TokenDataset:
    seqs = [tokenizer(t, truncation=True, max_length=seq_len)["input_ids"] for t in texts]
    return TokenDataset.from_sequences(seqs, seq_len=seq_len, pad_id=tokenizer.pad_token_id or 0)


def _hf_load(name, *args, **kwargs):
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise RuntimeError("HF `datasets` not installed") from e
    try:
        return load_dataset(name, *args, **kwargs)
    except Exception as e:
        raise RuntimeError(f"could not load {name!r} (offline environment?); use "
                           "load_pretokenized_jsonl on a bundled file instead") from e


def convert_wiki_dataset(tokenizer, seq_len: int = 256) -> TokenDataset:
    """wikipedia 20231101.en train[0:2000] (`data_converter.py:12-18`)."""
    ds = _hf_load("wikimedia/wikipedia", "20231101.en", split="train[0:2000]")
    return _tokenize_texts(tokenizer, ds["text"], seq_len)


def convert_cnn_dataset(tokenizer, seq_len: int = 256) -> TokenDataset:
    """cnn_dailymail 1.0.0 test[0:2000] articles (`data_converter.py:20-26`)."""
    ds = _hf_load("cnn_dailymail", "1.0.0", split="test[0:2000]")
    return _tokenize_texts(tokenizer, ds["article"], seq_len)


def convert_wikimqa_dataset(tokenizer, seq_len: int = 256) -> TokenDataset:
    """LongBench 2wikimqa_e contexts (`data_converter.py:28-35`)."""
    ds = _hf_load("THUDM/LongBench", "2wikimqa_e", split="test")
    return _tokenize_texts(tokenizer, ds["context"], seq_len)


def convert_qasper_dataset(tokenizer, seq_len: int = 256) -> TokenDataset:
    """LongBench qasper_e contexts (`data_converter.py:36-43`)."""
    ds = _hf_load("THUDM/LongBench", "qasper_e", split="test")
    return _tokenize_texts(tokenizer, ds["context"], seq_len)


def convert_c4_dataset_eval(tokenizer, seq_len: int = 256) -> TokenDataset:
    """C4 en validation shard [:2000] (`data_converter.py:44-50`)."""
    ds = _hf_load("allenai/c4",
                  data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
                  split="validation[:2000]")
    return _tokenize_texts(tokenizer, ds["text"], seq_len)


def load_arrow_dir(path: str, seq_len: int = 256, pad_id: int = 0) -> TokenDataset:
    """A `datasets.save_to_disk` arrow directory of pre-tokenized rows (the
    reference bundles `dataset/openwebtext_eval/` and
    `dataset/c4_validation/` so, read through `load_from_disk`)."""
    try:
        from datasets import load_from_disk
    except ImportError as e:
        raise RuntimeError("HF `datasets` not installed") from e
    ds = load_from_disk(path)
    return TokenDataset.from_sequences(ds["input_ids"], seq_len=seq_len, pad_id=pad_id)


DATASET_CONVERTERS = {
    "wiki": convert_wiki_dataset,
    "cnn": convert_cnn_dataset,
    "wikimqa": convert_wikimqa_dataset,
    "qasper": convert_qasper_dataset,
    "c4": convert_c4_dataset_eval,
}


def load_dataset_by_name(name: str, tokenizer=None, seq_len: int = 256,
                         path: Optional[str] = None) -> TokenDataset:
    """The CLIs' dispatch: `jsonl:<path>` / `arrow:<path>` work offline;
    named hub datasets need a tokenizer and a network or a cache; any other
    existing path is read as pre-tokenized JSONL."""
    if name.startswith("jsonl:"):
        return load_pretokenized_jsonl(name[6:], seq_len=seq_len)
    if name.startswith("arrow:"):
        return load_arrow_dir(name[6:], seq_len=seq_len)
    if name in DATASET_CONVERTERS:
        if tokenizer is None:
            raise ValueError(f"dataset {name!r} needs a tokenizer")
        return DATASET_CONVERTERS[name](tokenizer, seq_len)
    if path or os.path.exists(name):
        return load_pretokenized_jsonl(path or name, seq_len=seq_len)
    raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_CONVERTERS)}")
