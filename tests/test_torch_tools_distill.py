"""The port's training path (`sequoia_torch/tools/distill.py`) against
`sequoia_tpu/tools/distill.py` on the CPU in f32, test-tiny, both sides
from the same JAX params (`params_from_numpy`) and numpy-seeded tokens:
the losses, every leaf's gradient against `jax.grad`, AdamW steps against
optax, the corpus; the tree-attention autograd Function by an f64
gradcheck and against autograd through the plain version. The trained
pair's statistics are in tests/test_torch_tools_trained_pair.py."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.tools import distill as jd  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.core.model import forward_batched  # noqa: E402
from sequoia_torch.kernels import build  # noqa: E402
from sequoia_torch.kernels.tree_attention import (  # noqa: E402
    TreeAttentionFunction, tree_attention, tree_attention_batched, tree_attention_batched_plain,
    tree_attention_plain)
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.ops import masks  # noqa: E402
from sequoia_torch.quant.quantize import tensors  # noqa: E402
from sequoia_torch.tools import distill  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")
B, T = 4, 16


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
    jp = jax_random_params(CFG_J, jax.random.PRNGKey(3), dtype=jnp.float32)
    teacher = jax_random_params(CFG_J, jax.random.PRNGKey(4), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.asarray([T, 11, 7, 2])
    lmask = (np.arange(T - 1)[None, :] < (lengths - 1)[:, None]).astype(np.float32)
    return jp, teacher, tokens, lmask


def _leaf_pairs(j_tree, p_tree):
    """(name, JAX array, port tensor) for every leaf, in field order."""
    names = ["embed", *[f"layers.{f}" for f in j_tree.layers._fields], "final_norm", "lm_head"]
    j_leaves = [j_tree.embed, *j_tree.layers, j_tree.final_norm, j_tree.lm_head]
    return list(zip(names, j_leaves, list(tensors(p_tree))))


def _loss_fns(kind, teacher_j, teacher_p, tokens, lmask):
    """(JAX loss of params, port loss of params) for one kind of loss."""
    jt, pt = jnp.asarray(tokens), torch.as_tensor(tokens, dtype=torch.long)
    jm = None if lmask is None else jnp.asarray(lmask)
    pm = None if lmask is None else torch.as_tensor(lmask)
    if kind == "lm":
        return (lambda p: jd.lm_loss(p, CFG_J, jt, loss_mask=jm),
                lambda p: distill.lm_loss(p, CFG, pt, loss_mask=pm))
    jl = jd._batch_logits(teacher_j, CFG_J, jt)
    with torch.no_grad():
        pl = distill._batch_logits(teacher_p, CFG, pt)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    return (lambda p: jd.distill_loss(p, CFG_J, jl, jt, temperature=0.7, loss_mask=jm),
            lambda p: distill.distill_loss(p, CFG, pl, pt, temperature=0.7, loss_mask=pm))


@pytest.mark.parametrize("kind", ["lm", "distill"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(setup, kind, masked):
    jp, teacher, tokens, lmask = setup
    jf, pf = _loss_fns(kind, teacher, _to_port(teacher), tokens, lmask if masked else None)
    with torch.no_grad():
        got = float(pf(_to_port(jp)))
    np.testing.assert_allclose(got, float(jf(jp)), rtol=1e-5)


@pytest.mark.parametrize("kind", ["lm", "distill"])
def test_every_leaf_gradient_matches_jax_grad(setup, kind):
    """The port's loss.backward() (through TreeAttentionFunction and the
    out-of-place cache rows) against jax.grad: each leaf within 1e-4 of
    its largest |grad|."""
    jp, teacher, tokens, lmask = setup
    jf, pf = _loss_fns(kind, teacher, _to_port(teacher), tokens, lmask)
    jg = jax.grad(jf)(jp)
    pp = _to_port(jp)
    for t in tensors(pp):
        t.requires_grad_(True)
    pf(pp).backward()
    for name, j, p in _leaf_pairs(jg, pp):
        j = np.asarray(j)
        assert p.grad is not None, name
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), j, rtol=0, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)


def test_grad_forward_writes_the_cache_as_without_grad(setup):
    """Under autograd the float cache is still written in place, with the
    same rows and logits as a run without grad."""
    jp, _, tokens, _ = setup
    toks = torch.as_tensor(tokens, dtype=torch.long)
    pos = torch.arange(T).expand(B, T)
    mask = masks.causal_mask(T, T, 0, device="cpu").expand(B, T, T)
    out = []
    for grad in (False, True):
        pp = _to_port(jp)
        if grad:
            for t in tensors(pp):
                t.requires_grad_(True)
        kv = KVCache.init(CFG, T, torch.float32, device="cpu", batch=B)
        logits, _ = forward_batched(pp, CFG, toks, pos, kv, torch.zeros(B, dtype=torch.long),
                                    mask)
        assert logits.requires_grad == grad
        out.append((logits.detach(), kv.k.detach().clone(), kv.v.detach().clone()))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[0][1].abs().sum() > 0


def _attention_inputs(dtype, batched, seed=0):
    """Grouped heads (H 4, Hkv 2), a main cache and a scratch, and a query
    row that attends nothing (its scores all masked)."""
    g = torch.Generator().manual_seed(seed)
    Bn, Q, H, Hkv, D, M, S = 2, 5, 4, 2, 8, 7, 3
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(dtype)  # noqa: E731
    q, k, v = r(Bn, Q, H, D), r(Bn, M, Hkv, D), r(Bn, M, Hkv, D)
    sk, sv = r(Bn, S, Hkv, D), r(Bn, S, Hkv, D)
    main = torch.rand(Bn, Q, M, generator=g) < 0.6
    scr = torch.rand(Bn, Q, S, generator=g) < 0.6
    main[:, 0] = True
    main[:, 2], scr[:, 2] = False, False        # the masked row
    scr[1, 3] = False
    if not batched:
        q, k, v, sk, sv, main, scr = (t[0] for t in (q, k, v, sk, sv, main, scr))
    return q, k, v, main, sk, sv, scr


@pytest.mark.parametrize("batched", [False, True])
def test_attention_function_gradcheck_f64(batched):
    q, k, v, main, sk, sv, scr = _attention_inputs(torch.float64, batched)
    diff = [t.requires_grad_(True) for t in (q, k, v, sk, sv)]

    def fn(q, k, v, sk, sv):
        return TreeAttentionFunction.apply(q, k, v, main, sk, sv, scr, 0.35, batched)

    assert torch.autograd.gradcheck(fn, diff, eps=1e-6, atol=1e-8, rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("batched", [False, True])
def test_attention_function_equals_autograd_through_plain(dtype, tol, batched):
    """The wrapper under grad (the Function) against autograd through the
    plain version, on the same inputs and output gradient: outputs and
    every input's gradient within `tol` of the largest |value|."""
    inputs = _attention_inputs(dtype, batched, seed=1)
    dout = torch.randn(inputs[0].shape, generator=torch.Generator().manual_seed(2),
                       dtype=torch.float64).to(dtype)
    wrapper = tree_attention_batched if batched else tree_attention
    plain = tree_attention_batched_plain if batched else tree_attention_plain
    res = []
    for fn in (wrapper, plain):
        q, k, v, main, sk, sv, scr = (t.clone() for t in inputs)
        diff = [t.requires_grad_(True) for t in (q, k, v, sk, sv)]
        out = fn(q, k, v, main, sk, sv, scr, scale=0.35)
        assert out.grad_fn is not None
        out.backward(dout)
        res.append([out.detach()] + [t.grad for t in diff])
    for a, b in zip(*res):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.double(), b.double(), rtol=0,
                                   atol=tol * float(b.double().abs().max()))


def test_attention_function_only_under_grad():
    q, k, v, main, sk, sv, scr = _attention_inputs(torch.float32, True)
    out = tree_attention_batched(q, k, v, main, sk, sv, scr, scale=0.35)
    assert out.grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert tree_attention_batched(q, k, v, main, sk, sv, scr, scale=0.35).grad_fn is None
    fn = tree_attention_batched(q, k, v, main, sk, sv, scr, scale=0.35).grad_fn
    assert type(fn).__name__ == "TreeAttentionFunctionBackward"


@pytest.mark.parametrize("batched", [False, True])
def test_quantized_cache_under_grad_raises(batched):
    q, k, v, main, sk, sv, scr = _attention_inputs(torch.float32, batched)
    k8, v8 = k.round().clamp(-127, 127).to(torch.int8), v.round().to(torch.int8)
    ks = torch.ones(k.shape[:-1], dtype=torch.float32)
    fn = tree_attention_batched if batched else tree_attention
    out = fn(q, k8, v8, main, sk, sv, scr, scale=0.35, ks=ks, vs=ks)   # no grad: runs
    assert torch.isfinite(out).all()
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="int8 / int4 KV cache"):
        fn(q, k8, v8, main, sk, sv, scr, scale=0.35, ks=ks, vs=ks)


def test_refuse_grad():
    x = torch.ones(2, 3)
    build.refuse_grad("k", x, None)
    x.requires_grad_(True)
    with torch.no_grad():
        build.refuse_grad("k", x)
    with pytest.raises(RuntimeError, match="no backward"):
        build.refuse_grad("k", None, x)


def _train_both(setup, steps, kind):
    jp, teacher, tokens, _ = setup
    data = np.random.default_rng(5).integers(0, CFG.vocab_size, size=(12, T)).astype(np.int32)
    kw = dict(steps=steps, batch_size=3, seed=9)
    if kind == "schedule":
        kw["lr"] = lambda i: 3e-3 * 0.8 ** i
    jkw, pkw = dict(kw), dict(kw)
    if kind == "distill":
        lengths = np.random.default_rng(6).integers(2, T + 1, size=12)
        jkw.update(teacher=(teacher, CFG_J), mix_ce=0.5, distill_temperature=0.8,
                   lengths=lengths)
        pkw.update(teacher=(_to_port(teacher), CFG), mix_ce=0.5, distill_temperature=0.8,
                   lengths=lengths)
    j = jd.train_lm(CFG_J, data, init=jp, **jkw)
    p = distill.train_lm(CFG, data, init=_to_port(jp), device="cpu", **pkw)
    return jp, j, p


@pytest.mark.parametrize("steps,kind", [(1, "ce"), (5, "ce"), (5, "schedule"), (5, "distill")])
def test_train_lm_matches_optax(setup, steps, kind):
    """AdamW (lr 3e-3 or a schedule of the step, weight decay 0.01) from the
    same init and seed as optax.adamw, after `steps` steps (each moves a
    weight by up to ~lr): 99.9% of each leaf's elements within 2e-6 of
    JAX's, and every element within 5% of one step (1.5e-4). Adam divides
    by sqrt(v), so an element whose gradient is at f32 rounding noise
    moves by a different fraction of lr on each side (seen: 6.5e-5 on one
    element of 16384); a wrong gradient or update moves whole leaves by
    ~lr."""
    jp, j, p = _train_both(setup, steps, kind)
    moved = 0.0
    for (name, a, b), (_, a0, _) in zip(_leaf_pairs(j, p), _leaf_pairs(jp, p)):
        assert not b.requires_grad and b.grad_fn is None, name
        a = np.asarray(a)
        moved = max(moved, float(np.abs(a - np.asarray(a0)).max()))
        diff = np.abs(b.numpy() - a)
        assert np.quantile(diff, 0.999) <= 2e-6, (name, np.quantile(diff, 0.999))
        assert diff.max() <= 0.05 * 3e-3, (name, diff.max())
    assert moved > 1e-3


def test_train_lm_default_init_and_losses():
    data = distill.corpus_from_reference(vocab_size=CFG.vocab_size, seq_len=T, limit=16)
    losses = []
    p = distill.train_lm(CFG, data, steps=3, batch_size=2, device="cpu", losses=losses)
    assert len(losses) == 3 and all(x.dim() == 0 and not x.requires_grad for x in losses)
    assert all(not t.requires_grad for t in tensors(p))
    if not torch.cuda.is_available():   # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            distill.train_lm(CFG, data, steps=1)


@pytest.mark.parametrize("vocab,seq_len,limit", [(512, 64, 200), (256, 48, 7), (32000, 40, 3)])
def test_corpus_from_reference_equals_jax(vocab, seq_len, limit):
    want = jd.corpus_from_reference(vocab_size=vocab, seq_len=seq_len, limit=limit)
    got = distill.corpus_from_reference(vocab_size=vocab, seq_len=seq_len, limit=limit)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 256), (2, 128), (3, 768)])
def test_shape_cfg_equals_jax(shape):
    got = distill._shape_cfg(port_config("test-small"), *shape)
    want = jd._shape_cfg(get_config("test-small"), *shape)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
