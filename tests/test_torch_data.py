"""The port's data layer (`sequoia_torch/data/`) and the testbed's prompt
sources against the JAX package's, on the files the repo bundles
(`sequoia_tpu/data/bundled/`, read by path) and on a tiny arrow directory
written with the installed HF `datasets`: identical arrays."""

import json
import pathlib

import numpy as np
import pytest

from sequoia_tpu.cli import testbed as jax_testbed
from sequoia_tpu.data import datasets as jd
from sequoia_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from sequoia_torch.cli import testbed
from sequoia_torch.data import datasets as td
from sequoia_torch.data.tokenizer import ByteTokenizer

BUNDLED = pathlib.Path(__file__).resolve().parents[1] / "sequoia_tpu" / "data" / "bundled"
C4 = str(BUNDLED / "c4_small.json")
MT_BENCH = str(BUNDLED / "mt_bench.jsonl")


def _same(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.ids.dtype == b.ids.dtype == np.int32 and a.pad_id == b.pad_id


@pytest.mark.parametrize("seq_len,limit", [(256, None), (64, 5)])
def test_bundled_c4_same_arrays(seq_len, limit):
    got = td.load_pretokenized_jsonl(C4, seq_len=seq_len, limit=limit)
    _same(got, jd.load_pretokenized_jsonl(C4, seq_len=seq_len, limit=limit))
    assert len(got) == (limit or 200)
    _same(td.load_dataset_by_name(f"jsonl:{C4}", seq_len=seq_len),
          jd.load_dataset_by_name(f"jsonl:{C4}", seq_len=seq_len))
    _same(td.load_dataset_by_name(C4, seq_len=seq_len), jd.load_dataset_by_name(C4, seq_len=seq_len))
    _same(got.select(2, 5), jd.load_pretokenized_jsonl(C4, seq_len=seq_len, limit=limit).select(2, 5))


@pytest.mark.parametrize("turn", [0, 1])
def test_bundled_mt_bench_and_the_chat_template(turn):
    got = td.load_mt_bench_prompts(MT_BENCH, turn=turn)
    assert got == jd.load_mt_bench_prompts(MT_BENCH, turn=turn) and len(got) == 80
    assert [td.format_inst(p) for p in got] == [jd.format_inst(p) for p in got]


@pytest.mark.parametrize("add_bos", [True, False])
def test_byte_tokenizer_same_ids(add_bos):
    text = "".join(td.load_mt_bench_prompts(MT_BENCH)[:5]) + " é漢字\n"
    tok, ref = ByteTokenizer(add_bos), JaxByteTokenizer(add_bos)
    ids = tok(text)["input_ids"]
    assert ids == ref(text)["input_ids"]
    assert tok.decode(ids) == ref.decode(ids) == text
    assert tok.convert_ids_to_tokens(ids[:8]) == ref.convert_ids_to_tokens(ids[:8])


def test_arrow_dir_same_arrays(tmp_path):
    datasets = pytest.importorskip("datasets")
    rows = [list(r) for r in jd.load_pretokenized_jsonl(C4, seq_len=300, limit=6)]
    path = str(tmp_path / "arrow")
    datasets.Dataset.from_dict({"input_ids": rows}).save_to_disk(path)
    _same(td.load_arrow_dir(path, seq_len=96), jd.load_arrow_dir(path, seq_len=96))
    _same(td.load_dataset_by_name(f"arrow:{path}", seq_len=128),
          jd.load_dataset_by_name(f"arrow:{path}", seq_len=128))


def test_token_dataset_checks():
    ds = td.TokenDataset.from_sequences([[1, 2, 3], [4], [5, 6]], seq_len=5, pad_id=9)
    _same(ds, jd.TokenDataset.from_sequences([[1, 2, 3], [4], [5, 6]], seq_len=5, pad_id=9))
    with pytest.raises(ValueError, match="exceeds seq_len"):
        td.TokenDataset.from_sequences([[1, 2, 3, 4]], seq_len=3, truncate=False)
    with pytest.raises(ValueError):
        td.TokenDataset(np.zeros((2, 3)), np.array([4, 1]))
    with pytest.raises(KeyError):
        td.load_dataset_by_name("nope-such-dataset")
    with pytest.raises(ValueError, match="tokenizer"):
        td.load_dataset_by_name("c4")


@pytest.mark.parametrize("spec", ["jsonl", "json-file", "synthetic:3,17"])
@pytest.mark.parametrize("prefill_len", [0, 100])
def test_testbed_prompts_same_as_jax(tmp_path, spec, prefill_len):
    """`load_prompts` of both testbeds: the same prompts for `jsonl:`, a
    JSON file of token-id lists and `synthetic:`, with and without a forced
    prefill length (ids clipped to the vocabulary)."""
    if spec == "jsonl":
        spec = f"jsonl:{C4}"
    elif spec == "json-file":
        path = tmp_path / "prompts.json"
        path.write_text(json.dumps([[5, 6, 7], list(range(3, 140))]))
        spec = str(path)
    got = testbed.load_prompts(spec, 32000, 4, prefill_len=prefill_len)
    want = jax_testbed.load_prompts(spec, 32000, 4, prefill_len=prefill_len)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
