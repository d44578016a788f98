"""Tensor-parallel sharding of sequoia_torch (`parallel/sharding.py`) on
the CPU, without processes: each rank's shard against the JAX package's
`tp_param_specs` on conftest's 8 virtual CPU devices, the re-packed
row-parallel int4 shards, the KV and batched-state splits, the global
activation row maxima, the meta-device memory reckoning against JAX's
shard shapes, and the package root's exports against `sequoia_tpu`'s."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import sequoia_torch  # noqa: E402
import sequoia_tpu  # noqa: E402
from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.parallel import sharding as jsh  # noqa: E402
from sequoia_tpu.quant import qtensor as jq  # noqa: E402
from sequoia_tpu.quant.quantize import quantize_model as jax_quantize_model  # noqa: E402
from sequoia_tpu.quant.quantize import random_quantized_model as jax_random_quantized  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy, random_params  # noqa: E402
from sequoia_torch.kernels import quant_matmul as tqmm  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache, KVCache4, KVCache8  # noqa: E402
from sequoia_torch.parallel import aot_proof, sharding  # noqa: E402
from sequoia_torch.quant import qtensor as tq  # noqa: E402
from sequoia_torch.quant.quantize import quantize_model, random_quantized_model, tensors  # noqa: E402

FORMATS = ("float", "int8", "int4", "tiled")


def _jax_model(fmt, name="test-small"):
    params = jax_random_params(get_config(name), jax.random.PRNGKey(5), dtype=jnp.float32)
    if fmt == "float":
        return params
    q = jax_quantize_model(params, bits=8 if fmt == "int8" else 4)
    if fmt == "tiled":
        lay = q.layers
        q = q._replace(layers=lay._replace(**{
            f: jq.tile_int4(w, bn0=16) for f, w in lay._asdict().items()
            if isinstance(w, jq.QuantizedTensor)}))
    return q


def _jax_shard_shapes(params, tp):
    mesh = jsh.make_mesh(tp=tp)
    specs = jax.tree.leaves(jsh.tp_param_specs(params), is_leaf=lambda x: isinstance(x, P))
    return [NamedSharding(mesh, s).shard_shape(x.shape)
            for x, s in zip(jax.tree.leaves(params), specs)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_shapes_match_jax(fmt, tp):
    """Every leaf of every rank's shard has the shape of JAX's per-device
    shard of `tp_param_specs` (packed int4 row shards re-packed, tiled int4
    split on its panels), and is a contiguous tensor of its own."""
    jp = _jax_model(fmt)
    want = _jax_shard_shapes(jp, tp)
    full = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for rank in range(tp):
        got = list(tensors(sharding.shard_params_rank(full, tp, rank)))
        assert [tuple(t.shape) for t in got] == [tuple(s) for s in want]
        assert all(t.is_contiguous() for t in got)


@pytest.mark.parametrize("fmt", ["float", "int8", "int4", "tiled"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_hold_the_ranks_logical_slices(fmt, tp):
    """Dequantized, rank r's column shard is columns [r N/tp, (r+1) N/tp)
    of the whole weight and its row shard rows [r K/tp, (r+1) K/tp): for
    packed and tiled int4 the re-packed nibbles, bit for bit. A slice of the
    packed rows (JAX's spec) would hold two far-apart pieces of K."""
    cfg = port_config("test-small")
    full = params_from_numpy(jax.tree.map(np.asarray, _jax_model(fmt)), device="cpu")
    ins = {"wq": cfg.hidden_size, "wo": cfg.num_heads * cfg.head_dim_,
           "w_down": cfg.intermediate_size, "w_up": cfg.hidden_size}
    for rank in range(tp):
        shard = sharding.shard_params_rank(full, tp, rank)
        for f, K in ins.items():
            w, s = tq.layer(getattr(full.layers, f), 1), tq.layer(getattr(shard.layers, f), 1)
            whole = tq.dequantize(w, K) if isinstance(w, tq.QuantizedTensor) else w
            row = f in ("wo", "w_down")
            kk = K // tp if row else K
            part = tq.dequantize(s, kk) if isinstance(s, tq.QuantizedTensor) else s
            n = whole.shape[0 if row else 1] // tp
            want = whole[rank * n:(rank + 1) * n] if row else whole[:, rank * n:(rank + 1) * n]
            assert torch.equal(part, want), (f, rank)
    if fmt == "int4":
        q = tq.layer(full.layers.wo, 0).q
        naive = q[: q.shape[0] // tp]   # rank 0's packed rows as JAX's spec cuts them
        assert not torch.equal(tqmm.unpack_int4(naive), tqmm.unpack_int4(q)[: 2 * naive.shape[0]])


def test_pack_int4_inverts_unpack():
    v = torch.randint(-8, 8, (3, 10, 7), dtype=torch.int8)
    assert torch.equal(tqmm.unpack_int4(tq.pack_int4(v)), v)
    w = torch.randn(16, 24)
    assert torch.equal(tq.pack_int4(tqmm.unpack_int4(tq.quantize_int4(w).q)),
                       tq.quantize_int4(w).q)


def test_check_tp_divisibility_raises():
    cfg = port_config("test-small")   # 4 heads, 4 KV heads, F 256, V 512
    sharding.check_tp_divisibility(cfg, 4)
    with pytest.raises(ValueError, match="num_kv_heads"):
        sharding.check_tp_divisibility(cfg, 3)
    with pytest.raises(ValueError, match="num_kv_heads"):
        sharding.check_tp_divisibility(port_config("test-tiny"), 4)   # 2 KV heads
    with pytest.raises(ValueError):
        sharding.shard_config(port_config("test-tiny"), 4)


@pytest.mark.parametrize("hkv", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_kv4_packing_is_jaxs_rule(hkv, tp):
    """`sequoia_tpu/engine/engine.py:162-165`: head pairs when Hkv is even
    and (Hkv / 2) % tp == 0, else dsplit."""
    jax_rule = "dsplit" if hkv % 2 != 0 or (hkv // 2) % tp != 0 else "head"
    assert sharding.kv4_packing(hkv, tp) == jax_rule


@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("batch", [None, 3])
def test_shard_kv_splits_the_kv_heads(fmt, batch):
    """Each rank's cache is the same class over its heads: rows on the head
    (or head-pair) axis, scales on their head axis; the packing survives."""
    cfg = port_config("test-small")
    if fmt.startswith("int4"):
        kv = KVCache4.init(cfg, 8, packing=fmt[5:], device="cpu", batch=batch)
    else:
        kv = {"float": KVCache, "int8": KVCache8}[fmt].init(cfg, 8, torch.float32, "cpu",
                                                            batch=batch)
    for t in kv.tensors():
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    tp = 2
    for r in range(tp):
        part = sharding.shard_kv_rank(kv, tp, r)
        assert type(part) is type(kv)
        for f, whole, t in zip(kv._fields, kv.tensors(), part.tensors()):
            ax = sharding.tp_kv_spec()[f] % whole.dim()
            n = whole.shape[ax] // tp
            assert torch.equal(t, whole.narrow(ax, r * n, n)) and t.is_contiguous()
        if fmt.startswith("int4"):
            assert part.packing == fmt[5:]


def test_dp_share_is_contiguous_and_covers():
    for n in (1, 4, 7, 16):
        for dp in (1, 2, 3, 4):
            shares = [sharding.dp_share(n, dp, r) for r in range(dp)]
            assert shares[0].start == 0 and shares[-1].stop == n
            assert all(a.stop == b.start for a, b in zip(shares, shares[1:]))
            sizes = [s.stop - s.start for s in shares]
            assert max(sizes) - min(sizes) <= 1


def test_shard_batched_state_takes_slots_and_heads(monkeypatch):
    """JAX `shard_batched_state`: the dp rank's slots on every leaf (axis 1
    of the caches) and the tp rank's KV heads."""
    from sequoia_torch.engine.batched import BatchState

    cfg = port_config("test-small")
    B, M, V = 4, 8, 16
    st = BatchState(tokens=torch.arange(B * M).reshape(B, M), gtl=torch.arange(B),
                    draft_kv=KVCache.init(cfg, M, torch.float32, "cpu", batch=B),
                    target_kv=KVCache8.init(cfg, M, device="cpu", batch=B),
                    root_draft_logits=torch.randn(B, V), terminal=torch.zeros(B, dtype=torch.bool))
    st.target_kv.ks.copy_(torch.randn(st.target_kv.ks.shape))
    axes = sharding.MeshAxes(tp=2, tp_rank=1, tp_group=None, dp=2, dp_rank=1, dp_group=None)
    monkeypatch.setattr(sharding, "mesh_axes", lambda mesh: axes)
    part = sharding.shard_batched_state(st, mesh=None)
    assert torch.equal(part.tokens, st.tokens[2:]) and torch.equal(part.gtl, st.gtl[2:])
    assert part.target_kv.k.shape == (cfg.num_layers, 2, M, 2, cfg.head_dim_)
    assert torch.equal(part.target_kv.ks, st.target_kv.ks[:, 2:, :, 2:])


def test_global_row_maxima_quantize_a_shard_as_the_whole_row():
    """A row-parallel shard of x quantized by the whole rows' maxima gives
    the whole row's int8 values and scales; by its own, other ones."""
    x = torch.randn(5, 64)
    x[:, 40] = 9.0   # the row maxima lie in the second half
    whole8, whole_s = tqmm.quantize_activations(x)
    amax = x.abs().amax(dim=-1, keepdim=True)
    part8, part_s = tqmm.quantize_activations(x[:, :32].contiguous(), amax)
    assert torch.equal(part8, whole8[:, :32]) and torch.equal(part_s, whole_s)
    own8, _ = tqmm.quantize_activations(x[:, :32].contiguous())
    assert not torch.equal(own8, whole8[:, :32])


def test_w4a8_route_and_amax_argument():
    """`set_w4a8("on")` sends a row-major int4 weight through
    `quant_matmul(unpack="w4a8")` (not a tiled one); `amax` is refused on a
    route that does not quantize activations."""
    w = tq.quantize_int4(torch.randn(32, 24))
    x = torch.randn(3, 32)
    try:
        tq.set_w4a8("on")
        assert tq.quantizes_activations(x, w)
        assert not tq.quantizes_activations(x, tq.tile_int4(w, bn0=16))
        assert torch.equal(tq.matmul(x, w), tqmm.quant_matmul(x, w.q, w.scale, bits=4,
                                                              unpack="w4a8"))
        amax = torch.full((3, 1), 10.0)
        assert torch.equal(tq.matmul(x, w, amax=amax), tqmm.quant_matmul(
            x, w.q, w.scale, bits=4, unpack="w4a8", amax=amax))
        assert tq.w8a8_setting()[-1] == "on"
    finally:
        tq.set_w4a8("off")
    assert not tq.quantizes_activations(x, w)
    with pytest.raises(ValueError, match="amax"):
        tq.matmul(x, w, amax=torch.ones(3, 1))
    with pytest.raises(ValueError):
        tq.set_w4a8("auto")


def test_offloaded_params_are_not_sharded():
    from sequoia_torch.engine.offload import offload_params

    cfg = port_config("test-tiny")
    params = offload_params(random_params(cfg, 0, dtype=torch.float32, device="cpu"), 1,
                            device="cpu")
    with pytest.raises(ValueError, match="single-card"):
        sharding.shard_params_rank(params, 2, 0)


def test_meta_model_mirrors_random_quantized_model():
    """The meta model of the memory reckoning has the structure, shapes and
    dtypes of `random_quantized_model` (int8 and int4) and of a bf16 model."""
    cfg = port_config("test-tiny")
    for bits in (8, 4):
        real = random_quantized_model(cfg, 0, bits=bits, device="cpu")
        meta = aot_proof.meta_quantized_model(cfg, bits)
        assert [(t.shape, t.dtype) for t in tensors(real)] == \
            [(t.shape, t.dtype) for t in tensors(meta)]
    real = random_params(cfg, 0, device="cpu")
    meta = aot_proof.meta_quantized_model(cfg, None)
    assert [(t.shape, t.dtype) for t in tensors(real)] == [(t.shape, t.dtype) for t in tensors(meta)]


@pytest.mark.parametrize("name", ["llama-2-70b", "llama-2-7b"])
def test_aot_weight_bytes_equal_jax_shard_shapes(name):
    """One rank's int4 weight bytes under tp = 8, reckoned on the meta
    device, equal the sum of JAX's per-device shard shapes of the same
    model (`jax.eval_shape`, no compile)."""
    cfg = get_config(name)
    abstract = jax.eval_shape(lambda: jax_random_quantized(cfg, jax.random.PRNGKey(0), bits=4))
    want = sum(int(np.prod(s)) * leaf.dtype.itemsize
               for s, leaf in zip(_jax_shard_shapes(abstract, 8), jax.tree.leaves(abstract)))
    got = sharding.shard_params_rank(aot_proof.meta_quantized_model(port_config(name), 4), 8, 0)
    assert sum(t.numel() * t.element_size() for t in tensors(got)) == want


def test_aot_estimate_for_70b_tp8():
    """llama-2-70b int4 (draft llama-2-7b int4, sharded) under tp = 8 with
    the 64-node growmap at max_length 1024: one rank's weights are an
    eighth of the model's less the replicated embedding's share, and the
    whole fits one H100's 80 GB; the CLI prints the same numbers."""
    est = aot_proof.tp_memory_estimate("llama-2-70b", "llama-2-7b", tp=8, max_length=1024)
    assert est.tree_size == 64 and est.fits_h100
    whole = aot_proof.meta_quantized_model(port_config("llama-2-70b"), 4)
    total = sum(t.numel() * t.element_size() for t in tensors(whole))
    assert total / 8 < est.target_weight_bytes < total / 4
    assert est.total_bytes < 8e9


def test_package_root_exports_what_sequoia_tpu_exports():
    """ROADMAP C6: every public name of `sequoia_tpu` resolves on
    `sequoia_torch`, BatchedSpecEngine included."""
    from sequoia_torch.engine.batched import BatchedSpecEngine

    for name in sequoia_tpu.__all__:
        assert name in sequoia_torch.__all__
        assert getattr(sequoia_torch, name) is not None
    assert sequoia_torch.BatchedSpecEngine is BatchedSpecEngine
