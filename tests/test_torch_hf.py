"""HF checkpoints in the port (`core/init.py`): a tiny random
`LlamaForCausalLM` saved with the installed transformers (nothing is
downloaded) loads through the port's loader, and its f32 logits are
allclose to HF's and to the JAX package's forward on the same checkpoint;
export -> load is an identity; the testbed takes a checkpoint directory;
and no module of the port imports safetensors or transformers when it is
imported."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.init import load_hf_checkpoint as jax_load  # noqa: E402
from sequoia_tpu.core.model import forward as jax_forward  # noqa: E402
from sequoia_tpu.kvcache.cache import KVCache as JaxKV  # noqa: E402
from sequoia_tpu.ops import masks as jax_masks  # noqa: E402
from sequoia_torch.cli.testbed import build_params  # noqa: E402
from sequoia_torch.core.config import get_config  # noqa: E402
from sequoia_torch.core.init import (  # noqa: E402
    export_hf_checkpoint,
    load_hf_checkpoint,
    param_count,
    random_params,
)
from sequoia_torch.core.model import forward  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.ops import masks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
IDS = np.array([5, 7, 99, 13, 1, 64, 100, 2, 77])
LLAMA3_ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf():
    """transformers' Llama classes (importing them takes seconds, once)."""
    from transformers import LlamaConfig, LlamaForCausalLM

    return LlamaConfig, LlamaForCausalLM


def _hf_model(hf, num_kv_heads=2, rope_scaling=None, tie=False):
    HFConfig, LlamaForCausalLM = hf
    torch.manual_seed(3)
    cfg = HFConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=num_kv_heads,
                   max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
                   tie_word_embeddings=tie, attn_implementation="eager",
                   rope_scaling=rope_scaling)
    return LlamaForCausalLM(cfg).eval()


def _port_logits(params, cfg, ids):
    T = len(ids)
    logits, _ = forward(params, cfg, torch.as_tensor(ids), torch.arange(T),
                        KVCache.init(cfg, 16, torch.float32, "cpu"), 0,
                        masks.causal_mask(T, 16, 0, "cpu"))
    return logits.numpy()


@pytest.mark.parametrize("layout", [
    "safetensors", "bin", "safetensors-sharded", "bin-sharded", "llama3-rope-tied"])
def test_checkpoint_logits_match_hf_and_jax(hf, tmp_path, layout):
    """Single-file and sharded, safetensors and `.bin`, and a Llama-3 rope
    scaling with tied embeddings (positions 0..8 against an original max of
    16 put frequency pairs in all three bands). f32 logits within 2e-4 of
    HF's (JAX's own test holds its forward to that) and 1e-5 of JAX's (the
    same math in f32)."""
    llama3 = layout == "llama3-rope-tied"
    model = _hf_model(hf, rope_scaling=LLAMA3_ROPE if llama3 else None, tie=llama3)
    path = str(tmp_path / "ckpt")
    shard = {"max_shard_size": "100KB"} if layout.endswith("sharded") else {}
    model.save_pretrained(path, safe_serialization=not layout.startswith("bin"), **shard)
    names = {p.name for p in (tmp_path / "ckpt").iterdir()}
    assert any(n.endswith(".index.json") for n in names) == bool(shard), names

    params, cfg = load_hf_checkpoint(path, dtype=torch.float32, device="cpu")
    assert cfg.num_kv_heads == 2 and cfg.tie_word_embeddings == llama3
    assert (cfg.rope_scaling_factor == 32.0) == llama3
    got = _port_logits(params, cfg, IDS)
    with torch.no_grad():
        ref = model(torch.as_tensor(IDS[None])).logits[0].float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    jparams, jcfg = jax_load(path, dtype=jnp.float32)
    T = len(IDS)
    want, _ = jax_forward(jparams, jcfg, jnp.asarray(IDS, jnp.int32),
                          jnp.arange(T, dtype=jnp.int32), JaxKV.init(jcfg, 16, jnp.float32), 0,
                          jax_masks.causal_mask(T, 16, 0))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert param_count(params) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("weights", ["safetensors", "bin"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_export_then_load_is_identity(hf, tmp_path, weights, dtype):
    """Every tensor back bit for bit (bf16 goes out as f32, exactly), the
    config's fields back, and the exported directory loads in HF
    `LlamaForCausalLM` with logits allclose to the port's."""
    cfg = get_config("test-tiny")
    params = random_params(cfg, 5, dtype=dtype, device="cpu")
    path = str(tmp_path / "export")
    export_hf_checkpoint(params, cfg, path, weights=weights)
    back, cfg2 = load_hf_checkpoint(path, dtype=dtype, device="cpu")
    for name in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                 "num_kv_heads", "rope_theta", "rms_norm_eps", "tie_word_embeddings"):
        assert getattr(cfg2, name) == getattr(cfg, name), name
    flat = lambda p: [p.embed, *p.layers, p.final_norm, p.lm_head]  # noqa: E731
    for a, b in zip(flat(params), flat(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if dtype == torch.float32:
        with torch.no_grad():
            ref = hf[1].from_pretrained(path).eval()(
                torch.as_tensor(IDS[None] % cfg.vocab_size)).logits[0].numpy()
        np.testing.assert_allclose(_port_logits(params, cfg, IDS % cfg.vocab_size), ref,
                                   rtol=2e-4, atol=2e-4)


def test_export_rejects_an_unknown_format(tmp_path):
    cfg = get_config("test-tiny")
    with pytest.raises(ValueError, match="safetensors"):
        export_hf_checkpoint(random_params(cfg, 0, dtype=torch.float32, device="cpu"), cfg,
                             str(tmp_path / "x"), weights="npz")


def test_testbed_builds_from_a_checkpoint_dir(tmp_path):
    """`--draft-weights DIR`, the directory as the model name with "auto",
    and a state-dict file: the checkpoint's weights, not random ones."""
    cfg = get_config("test-tiny")
    params = random_params(cfg, 9, dtype=torch.float32, device="cpu")
    path = str(tmp_path / "ckpt")
    export_hf_checkpoint(params, cfg, path, weights="bin")
    for name, weights in (("test-tiny", path), (path, "auto"),
                          ("test-tiny", str(tmp_path / "ckpt" / "pytorch_model.bin"))):
        got, got_cfg = build_params(name, weights, "f32", seed=0, device="cpu")
        assert got_cfg.hidden_size == cfg.hidden_size
        assert torch.equal(got.layers.wq, params.layers.wq), (name, weights)
    with pytest.raises(ValueError, match="neither a preset"):
        build_params(str(tmp_path / "missing"), "auto", "f32", seed=0, device="cpu")


def test_no_port_module_imports_safetensors_or_transformers():
    """A fresh interpreter imports every module of the port (the card's
    machine has neither package) and finds neither one loaded."""
    code = (
        "import importlib, json, pathlib, sys\n"
        "for p in sorted(pathlib.Path('sequoia_torch').rglob('*.py')):\n"
        "    importlib.import_module('.'.join(p.with_suffix('').parts).removesuffix('.__init__'))\n"
        "print(json.dumps([m for m in sys.modules\n"
        "                  if m.split('.')[0] in ('safetensors', 'transformers')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
