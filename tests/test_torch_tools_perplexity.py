"""The port's perplexity tool (`sequoia_torch/tools/perplexity.py`) against
`sequoia_tpu/tools/perplexity.py` on the CPU, f32, test-tiny, both sides
from the same JAX params (`params_from_numpy`; quantized weights carried
across), with the rows and lengths of tests/test_perplexity.py; that
file's three properties on the port; and the CLI on an exported
checkpoint."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.quant.quantize import quantize_model as jax_quantize_model  # noqa: E402
from sequoia_tpu.tools.perplexity import evaluate as jax_evaluate  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import export_hf_checkpoint, load_hf_checkpoint  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.quant.quantize import quantize_model  # noqa: E402
from sequoia_torch.tools import perplexity  # noqa: E402
from sequoia_torch.tools.perplexity import evaluate  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


@pytest.fixture(scope="module")
def setup():
    """tests/test_perplexity.py's model, rows and lengths."""
    params = jax_random_params(CFG_J, jax.random.PRNGKey(5), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFG.vocab_size, size=(4, 48)).astype(np.int32)
    lengths = np.asarray([48, 40, 33, 17])
    return params, ids, lengths


@pytest.mark.parametrize("weights,kv_quant", [
    ("f32", None), ("f32", "int8"), ("f32", "int4"), ("int8", None), ("int4", None),
    ("int8", "int8"), ("int4", "int4")])
def test_evaluate_matches_jax(setup, weights, kv_quant):
    """Tokens equal, NLL within 1e-5 relative, for every weight format and
    KV cache (chunk 16: three chunks a row, later ones over quantized
    history)."""
    params, ids, lengths = setup
    if weights != "f32":
        params = jax_quantize_model(params, bits=int(weights[3:]))
    want = jax_evaluate(params, CFG_J, ids, lengths, chunk=16, kv_quant=kv_quant)
    got = evaluate(_to_port(params), CFG, ids, lengths, chunk=16, kv_quant=kv_quant)
    assert got.tokens == want.tokens == int((lengths - 1).sum())
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-5)
    np.testing.assert_allclose(got.perplexity, want.perplexity, rtol=1e-4)


def test_uniform_model_nll_is_log_vocab(setup):
    params, ids, lengths = setup
    p = _to_port(params)
    zeroed = p._replace(lm_head=torch.zeros_like(p.lm_head))
    res = evaluate(zeroed, CFG, ids, lengths, chunk=16)
    assert res.tokens == int((lengths - 1).sum())
    np.testing.assert_allclose(res.nll, np.log(CFG.vocab_size), rtol=1e-5)


def test_padding_and_chunk_invariance(setup):
    params, ids, lengths = setup
    p = _to_port(params)
    a = evaluate(p, CFG, ids, lengths, chunk=16)
    # Extra pad columns must not change the score; nor must chunking.
    wide = np.concatenate([ids, np.zeros((4, 16), np.int32)], axis=1)
    b = evaluate(p, CFG, wide, lengths, chunk=64)
    np.testing.assert_allclose(a.nll, b.nll, rtol=1e-4)
    assert a.tokens == b.tokens
    c = evaluate(p, CFG, ids, lengths, chunk=20)   # a ragged last chunk (48 = 20 + 20 + 8)
    np.testing.assert_allclose(a.nll, c.nll, rtol=1e-4)
    assert evaluate(p, CFG, ids, lengths, chunk=16, limit=2).tokens == int((lengths[:2] - 1).sum())


def test_int8_quantization_delta_small(setup):
    params, ids, lengths = setup
    p = _to_port(params)
    base = evaluate(p, CFG, ids, lengths, chunk=16)
    q8 = evaluate(quantize_model(p, bits=8), CFG, ids, lengths, chunk=16)
    # int8 per-channel weight quantization barely moves NLL.
    assert abs(q8.nll - base.nll) < 0.05 * max(base.nll, 1.0)
    q4 = evaluate(quantize_model(p, bits=4), CFG, ids, lengths, chunk=16)
    # int4 drifts more but must stay finite/sane on a tiny random model.
    assert np.isfinite(q4.nll)


def test_short_rows_are_skipped(setup):
    params, ids, _ = setup
    res = evaluate(_to_port(params), CFG, ids, np.asarray([1, 0, 2, 3]), chunk=16)
    assert res.tokens == 1 + 2


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_on_exported_checkpoint(setup, tmp_path, capsys, quant):
    """`python -m sequoia_torch.tools.perplexity --device cpu` on a
    test-tiny checkpoint exported by the port: one JSON line with JAX's
    keys, equal to `evaluate` on the checkpoint loaded in bf16."""
    params, ids, lengths = setup
    ckpt = tmp_path / "ckpt"
    export_hf_checkpoint(_to_port(params), CFG, str(ckpt), weights="bin")
    data = tmp_path / "rows.jsonl"
    with open(data, "w") as f:
        for row, ln in zip(ids, lengths):
            f.write(json.dumps({"input_tokens": row[:ln].tolist()}) + "\n")
    perplexity.main(["--model", str(ckpt), "--data", str(data), "--quant", quant,
                     "--seq-len", "48", "--chunk", "16", "--limit", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"model", "quant", "nll", "perplexity", "tokens"}
    p, cfg = load_hf_checkpoint(str(ckpt), dtype=torch.bfloat16, device="cpu")
    if quant != "none":
        p = quantize_model(p, bits=8)
    want = evaluate(p, cfg, ids, lengths, chunk=16, limit=3)
    assert out["quant"] == quant and out["tokens"] == want.tokens == int((lengths[:3] - 1).sum())
    assert out["nll"] == round(want.nll, 5) and np.isfinite(out["perplexity"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            perplexity.main(["--model", str(ckpt), "--data", str(data)])
