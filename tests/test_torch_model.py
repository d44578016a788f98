"""The port's model forward, masks and config against the JAX package, on
the CPU in f32 (test-tiny, JAX weights carried across with
`params_from_numpy`)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core import config as jconfig  # noqa: E402
from sequoia_tpu.core import model as jmodel  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.kvcache.cache import KVCache as JKV  # noqa: E402
from sequoia_tpu.ops import masks as jmasks  # noqa: E402
from sequoia_torch.core import config as tconfig  # noqa: E402
from sequoia_torch.core import model as tmodel  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.ops import masks as tmasks  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

CFG_J = jconfig.get_config("test-tiny")
CFG_T = tconfig.get_config("test-tiny")
M = 64
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jax_random_params(CFG_J, jax.random.PRNGKey(8), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_presets_are_copies():
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert dataclasses.asdict(tconfig.PRESETS[name]) == dataclasses.asdict(
            jconfig.PRESETS[name])


@pytest.mark.parametrize("name,scaling", [("test-tiny", 8.0), ("llama-3.1-8b", None),
                                          ("llama-2-7b", None)])
def test_rope_inv_freq(name, scaling):
    jc, tc = jconfig.get_config(name), tconfig.get_config(name)
    if scaling is not None:
        jc = dataclasses.replace(jc, rope_scaling_factor=scaling,
                                 rope_scaling_original_max_position=64)
        tc = dataclasses.replace(tc, rope_scaling_factor=scaling,
                                 rope_scaling_original_max_position=64)
    np.testing.assert_allclose(tmodel.rope_inv_freq(tc).numpy(),
                               np.asarray(jmodel.rope_inv_freq(jc)), rtol=1e-6)


def test_masks_match():
    gm = uniform_tree(2, 3)
    anc = gm.ancestors[1:5]
    np.testing.assert_array_equal(tmasks.causal_mask(5, M, 7, "cpu").numpy(),
                                  np.asarray(jmasks.causal_mask(5, M, 7)))
    np.testing.assert_array_equal(tmasks.tree_mask_rows(torch.as_tensor(anc), 9, M).numpy(),
                                  np.asarray(jmasks.tree_mask_rows(jnp.asarray(anc), 9, M)))
    for root_in_main in (True, False):
        tm, ts = tmasks.split_tree_masks(torch.as_tensor(anc), 9, M, root_in_main)
        jm, js = jmasks.split_tree_masks(anc, 9, M, root_in_main)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _both_caches(size):
    return (JKV.init(CFG_J, size, jnp.float32),
            KVCache.init(CFG_T, size, torch.float32, "cpu"))


def _prefill(jp, tp, n):
    """Write-mode prefill of n tokens into fresh caches on both sides."""
    toks = np.arange(3, 3 + n) * 7 % CFG_J.vocab_size
    pos = np.arange(n)
    jkv, tkv = _both_caches(M)
    jl, jkv = jmodel.forward(jp, CFG_J, jnp.asarray(toks), jnp.asarray(pos), jkv, 0,
                             jmasks.causal_mask(n, M, 0))
    tl, tkv = tmodel.forward(tp, CFG_T, torch.as_tensor(toks), torch.as_tensor(pos), tkv,
                             0, tmasks.causal_mask(n, M, 0, "cpu"))
    return jl, jkv, tl, tkv


def test_forward_prefill_write_mode(params):
    jp, tp = params
    jl, jkv, tl, tkv = _prefill(jp, tp, 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), **TOL)
    np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v), **TOL)


@pytest.mark.parametrize("mode", ["draft_grow", "verify"])
def test_forward_split_mode(params, mode):
    """Draft grow (one level, root in main) and verify (whole tree, root in
    the scratch) over a prefilled cache: logits and scratch rows agree."""
    jp, tp = params
    plen = 20
    _, jkv, _, tkv = _prefill(jp, tp, plen)
    gm = uniform_tree(2, 3)
    ts = plen - 1
    if mode == "draft_grow":
        start, w = gm.level_starts[1], gm.level_widths[1]
        rows, root_in_main, offset = slice(start, start + w), True, start
    else:
        rows, root_in_main, offset = slice(0, gm.size), False, 0
    anc = gm.ancestors[rows]
    toks = (np.arange(gm.size) * 13 + 5)[rows] % CFG_J.vocab_size
    pos = ts + gm.depth[rows]
    jmain, jscr = jmasks.split_tree_masks(anc, ts, M, root_in_main)
    tmain, tscr = tmasks.split_tree_masks(torch.as_tensor(anc), ts, M, root_in_main)
    jsc, tsc = _both_caches(gm.size)
    jl, jsc = jmodel.forward(jp, CFG_J, jnp.asarray(toks), jnp.asarray(pos), jkv, ts + offset,
                             jmain, scratch=jsc, scratch_offset=offset, scratch_mask=jscr)
    tl, tsc = tmodel.forward(tp, CFG_T, torch.as_tensor(toks), torch.as_tensor(pos), tkv,
                             ts + offset, tmain, scratch=tsc, scratch_offset=offset,
                             scratch_mask=tscr)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tsc.k.numpy(), np.asarray(jsc.k), **TOL)
    np.testing.assert_allclose(tsc.v.numpy(), np.asarray(jsc.v), **TOL)
    # The main cache is read-only in split mode.
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), **TOL)


def test_commit_rows_matches(params):
    jkv, tkv = _both_caches(M)
    rng = np.random.default_rng(0)
    scr = rng.standard_normal((CFG_J.num_layers, 7, CFG_J.num_kv_heads,
                               CFG_J.head_dim_)).astype(np.float32)
    src = np.array([0, 3, 5, 5])
    jout = jkv.commit_rows(JKV(k=jnp.asarray(scr), v=jnp.asarray(-scr)), jnp.asarray(src), 11)
    tout = tkv.commit_rows(KVCache(k=torch.as_tensor(scr), v=torch.as_tensor(-scr)),
                           torch.as_tensor(src), torch.tensor(11))
    np.testing.assert_array_equal(tout.k.numpy(), np.asarray(jout.k))
    np.testing.assert_array_equal(tout.v.numpy(), np.asarray(jout.v))


def test_params_from_numpy_layout(params):
    jp, tp = params
    assert tuple(tp.layers.wq.shape) == tuple(jp.layers.wq.shape)
    np.testing.assert_array_equal(tp.layers.w_down.numpy(), np.asarray(jp.layers.w_down))
    np.testing.assert_array_equal(tp.lm_head.numpy(), np.asarray(jp.lm_head))
    as_dict = {"embed": np.asarray(jp.embed), "final_norm": np.asarray(jp.final_norm),
               "lm_head": np.asarray(jp.lm_head),
               "layers": {f: np.asarray(getattr(jp.layers, f)) for f in jp.layers._fields}}
    again = params_from_numpy(as_dict, device="cpu", dtype=torch.bfloat16)
    assert again.layers.wk.dtype == torch.bfloat16
