"""The plain reference against cases worked out by hand, at a tiny size."""

import math

import pytest
import torch

from perfbench import gen
from perfbench.families.llama import Dims
from perfbench.reference import llama
from perfbench.reference.quant import as_served


def test_rms_norm_by_hand():
    x = torch.tensor([[3.0, 4.0]])
    # mean square 12.5
    assert torch.allclose(llama.rms_norm(x, 0.0), x / math.sqrt(12.5))


def test_rope_rotates_each_pair_by_position_times_frequency():
    D, theta = 4, 100.0
    x = torch.zeros(3, 1, D)
    x[:, 0, 0] = 1.0   # first half, frequency index 0: theta^0 = 1
    x[:, 0, 1] = 1.0   # frequency index 1: 1 / theta^(2/4) = 0.1
    out = llama.rope(x, theta)
    for t in range(3):
        assert out[t, 0, 0] == pytest.approx(math.cos(t))
        assert out[t, 0, 2] == pytest.approx(math.sin(t))
        assert out[t, 0, 1] == pytest.approx(math.cos(0.1 * t))
        assert out[t, 0, 3] == pytest.approx(math.sin(0.1 * t))


def test_attention_is_causal_grouped_softmax():
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 0.0], [0.0, 1.0]]])   # T 2, H 2, D 2
    k = torch.tensor([[[1.0, 0.0]], [[0.0, 2.0]]])                            # Hkv 1
    v = torch.tensor([[[1.0, 2.0]], [[3.0, 4.0]]])
    out = llama.attention(q, k, v)
    assert torch.allclose(out[0], v[0].expand(2, 2))          # one key: itself
    s = torch.tensor([1.0, 0.0]) / math.sqrt(2)               # head 0 at t = 1
    p = s.softmax(0)
    assert torch.allclose(out[1, 0], p[0] * v[0, 0] + p[1] * v[1, 0])
    s = torch.tensor([0.0, 2.0]) / math.sqrt(2)               # head 1
    p = s.softmax(0)
    assert torch.allclose(out[1, 1], p[0] * v[0, 0] + p[1] * v[1, 0])


def test_quant_rule_by_hand():
    w = torch.tensor([[1.0, -3.5], [0.25, 7.0], [-127.0, 2.5]]).to(torch.bfloat16)
    assert torch.equal(as_served(w, "bf16"), w.float())
    # column 0: scale 1 (max 127), so every value is a whole number
    assert torch.equal(as_served(w, "int8")[:, 0], torch.tensor([1.0, 0.0, -127.0]))
    # column 1 in int4: scale 1 (max 7); halves round to even
    assert torch.equal(as_served(w, "int4")[:, 1], torch.tensor([-4.0, 7.0, 2.0]))
    # column 1 in int8: scale 7/127; 2.5 is 45.36 steps, so 45
    assert as_served(w, "int8")[2, 1].item() == pytest.approx(45 * 7 / 127, rel=1e-6)
    # column 0 in int4: scale 127/7; 1.0 is 0.055 steps, so 0
    assert as_served(w, "int4")[0, 0].item() == 0.0


def test_logits_of_a_model_whose_layers_add_nothing(monkeypatch):
    """With every projection zero the hidden state is the embedding, so the
    logits are rms_norm(embedding row) @ head."""
    dims = Dims(vocab=16, hidden=8, intermediate=8, layers=2, heads=2, kv_heads=1,
                head_dim=4, rope_theta=1e4, eps=1e-5, tied=False)
    real = gen.projection
    monkeypatch.setattr(gen, "projection",
                        lambda d, s, r, leaf, i, device="cpu": real(d, s, r, leaf, i, device) * 0)
    seq = torch.tensor([3, 5, 7])
    out = llama.logits(dims, 11, "target", ["bf16"], [seq], [torch.tensor([0, 2])], "cpu")
    e = gen.embedding(dims, 11, "target").float()
    h = gen.head(dims, 11, "target").float()
    want = llama.rms_norm(e[seq[[0, 2]]], dims.eps) @ h
    assert torch.allclose(out[0][0], want, atol=1e-6)


def test_weights_are_the_same_for_a_seed_and_differ_across_seeds():
    dims = Dims(vocab=16, hidden=8, intermediate=8, layers=2, heads=2, kv_heads=1,
                head_dim=4, rope_theta=1e4, eps=1e-5, tied=True)
    a = gen.projection(dims, 2**31 + 5, "draft", "wq", 1)
    assert torch.equal(a, gen.projection(dims, 2**31 + 5, "draft", "wq", 1))
    assert not torch.equal(a, gen.projection(dims, 2**31 + 6, "draft", "wq", 1))
    assert not torch.equal(a, gen.projection(dims, 2**31 + 5, "draft", "wq", 0))
    assert torch.equal(gen.head(dims, 3, "target"), gen.embedding(dims, 3, "target").T)
    assert a.dtype == torch.bfloat16 and a.std().item() < 0.03
