"""The CUDA kernels against their plain versions, on the card. Skips
without a CUDA device. The file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sequoia_torch.kernels import top_p as tp
from sequoia_torch.kernels.tree_attention import tree_attention, tree_attention_plain


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _attention_inputs(Q, M, S, Hkv, g, D, dtype):
    rng = np.random.default_rng(Q + M + S)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    mask = torch.from_numpy(rng.random((Q, M)) < 0.7).cuda()
    mask[:, 0] = True
    smask = torch.tril(torch.ones(Q, S, dtype=torch.bool)).cuda()
    return t(Q, Hkv * g, D), t(M, Hkv, D), t(M, Hkv, D), mask, t(S, Hkv, D), t(S, Hkv, D), smask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Q,M,S,Hkv,g,D", [
    (64, 256, 64, 32, 1, 128),   # 7B verify
    (13, 256, 64, 12, 1, 64),    # 68m grow level
    (9, 48, 11, 2, 2, 16),       # test-tiny GQA, ragged
    (128, 256, 0, 4, 2, 32),     # prefill, empty scratch
    (1, 256, 1, 32, 1, 128),     # AR step
])
def test_tree_attention_kernel_matches_plain(Q, M, S, Hkv, g, D, dtype, tol):
    _need_cuda()
    args = _attention_inputs(Q, M, S, Hkv, g, D, dtype)
    got = tree_attention(*args, scale=D ** -0.5)
    want = tree_attention_plain(*args, scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("rows,vocab", [(64, 32000), (1, 32000), (7, 1000)])
def test_top_p_kernels_match_plain(rows, vocab, top_p):
    """The fused kernel and the plain bisection see the same probabilities
    and sum masses in f64: identical thresholds. The from-logits kernel
    does its own softmax, an ulp away from torch.softmax: identical nuclei
    except an ill-conditioned boundary token (`boundary_disagreements`),
    and |dt| <= 1e-6 on every row whose nucleus agrees."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(rows)
    logits = torch.randn(rows, vocab, generator=gen, device="cuda") * 3
    probs = torch.softmax(logits / 0.6, dim=-1)
    got = tp.top_p_threshold_fused(probs, top_p)
    torch.testing.assert_close(got, tp.top_p_threshold_plain(probs, top_p), rtol=0, atol=0)
    got = tp.top_p_threshold_from_logits(logits, top_p, 0.6)
    want = tp.top_p_threshold_from_logits_plain(logits, top_p, 0.6)
    tp.boundary_disagreements(probs, got, want, top_p)
    same = ((probs >= got[:, None]) == (probs >= want[:, None])).all(dim=1)
    assert torch.where(same, (got - want).abs(), 0.0).max().item() <= 1e-6


def test_boundary_disagreements_rejects_a_real_difference():
    probs = torch.tensor([[0.5, 0.3, 0.15, 0.05]])
    keep3 = torch.tensor([0.1])       # keeps 0.5, 0.3, 0.15
    keep2 = torch.tensor([0.2])       # keeps 0.5, 0.3
    keep1 = torch.tensor([0.4])
    assert tp.boundary_disagreements(probs, keep2, keep2, 0.8) == 0
    assert tp.boundary_disagreements(probs, keep3, keep2, 0.8) == 1  # mass 0.8 above 0.15
    with pytest.raises(ValueError):
        tp.boundary_disagreements(probs, keep3, keep2, 0.9)          # well conditioned
    with pytest.raises(ValueError):
        tp.boundary_disagreements(probs, keep3, keep1, 0.8)          # two tokens


def test_cuda_tensor_never_takes_the_plain_version():
    """Without a card a CUDA tensor cannot exist; with one, a tensor on an
    unsupported device raises instead of running the plain version."""
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tp.top_p_threshold_fused(x, 0.9)
