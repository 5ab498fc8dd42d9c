"""Port vs JAX: the plain twin of kernels K3/K4 (ops/decode_attention.py) and
the int8 cache's write side.

The twin is held against the JAX Pallas kernel ``decode_attention_stacked``
in interpret mode, as tests/models/test_decode_attention.py runs it, at
L = 3, B = 2, S = 37, head_dim 16, with a ragged keep-mask (holes, and a
mid-decode row whose tail is unfilled), for both cache types:

- OPT: ``scale_query=True``, kv_heads = heads = 4;
- GQA: ``scale_query=False``, heads 8 over kv_heads 2.

Tolerances: fp32 atol 1e-5; bf16 atol = rtol = 2e-2 (one bf16 ulp of a rounded
score moves a probability by under 1%), NaN rows equal; the int8 body's JAX
bar is 3e-2, and the twin holds a tighter 1e-2 here because it dequantizes
with the same rounding points and only the fp32 sums' order can differ.
``quantize_kv``/``dequantize_kv`` are bit-equal to JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.ops import decode_attention as jda
from eilev_tpu_torch.ops import decode_attention as tda

from ._torch_port import to_np

L, B, S, HD = 3, 2, 37, 16
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYOUTS = {"opt": (4, 4, True), "gqa": (8, 2, False)}  # heads, kv_heads, scale_query


def _tol(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else dict(atol=2e-2, rtol=2e-2)


def _ragged_mask(seed, fully_masked_row=False):
    rng = np.random.default_rng(seed)
    m = (rng.random((B, S)) > 0.3).astype(np.int32)
    m[:, 0] = 1
    m[1, 25:] = 0  # mid-decode: slots past the filled prefix
    if fully_masked_row:
        m[1] = 0
    return m


def _inputs(nh, kvh, seed, hd=HD):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nh * hd)).astype(np.float32)
    k = rng.normal(size=(L, B, S, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(L, B, S, kvh, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("fully_masked_row", [False, True])
@pytest.mark.parametrize("layout", ["opt", "gqa"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_twin_matches_jax_kernel(dtype, layout, fully_masked_row):
    nh, kvh, scale_query = LAYOUTS[layout]
    jd, td = DTYPES[dtype]
    q, k, v = _inputs(nh, kvh, seed=1)
    k, v = k.reshape(L, B, S, kvh * HD), v.reshape(L, B, S, kvh * HD)
    m = _ragged_mask(2, fully_masked_row)
    kw = dict(num_heads=nh, head_dim=HD, kv_heads=kvh, scale_query=scale_query)
    for layer in range(L):
        ref = jda.decode_attention_stacked(
            jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(m),
            layer, interpret=True, **kw,
        )
        ours = tda.decode_attention_stacked_reference(
            torch.from_numpy(q).to(td), torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
            torch.from_numpy(m), layer, **kw,
        )
        assert ours.dtype == td and tuple(ours.shape) == (B, nh * HD)
        ref_np = to_np(ref)
        if fully_masked_row and dtype == "bf16":
            # finfo(float32).min is -inf in bf16: the reference row is NaN too
            assert np.isnan(ref_np[1]).all()
        np.testing.assert_allclose(to_np(ours), ref_np, equal_nan=True, **_tol(dtype))


def _torch(x):
    """A JAX int8 or bf16 array as a torch tensor of the same dtype."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


# the int8 layouts: LAYOUTS at head_dim 16, and the LLaMA decode form (4 heads
# x 128, groups of 1, score-side scale) that the card's cluster split takes
INT8_LAYOUTS = {**{name: (*lay, HD) for name, lay in LAYOUTS.items()}, "llama": (4, 4, False, 128)}


@pytest.mark.parametrize("layout", list(INT8_LAYOUTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_twin_matches_jax_kernel(dtype, layout):
    nh, kvh, scale_query, hd = INT8_LAYOUTS[layout]
    jd, td = DTYPES[dtype]
    q, k, v = _inputs(nh, kvh, seed=3, hd=hd)
    k8, ks = jda.quantize_kv(jnp.asarray(k, jd))
    v8, vs = jda.quantize_kv(jnp.asarray(v, jd))
    m = _ragged_mask(4)
    kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=scale_query)
    for layer in range(L):
        ref = jda.decode_attention_stacked(
            jnp.asarray(q, jd), k8.reshape(L, B, S, -1), v8.reshape(L, B, S, -1), jnp.asarray(m),
            layer, k_scale=ks, v_scale=vs, interpret=True, **kw,
        )
        ours = tda.decode_attention_stacked_reference(
            torch.from_numpy(q).to(td), _torch(k8).reshape(L, B, S, -1),
            _torch(v8).reshape(L, B, S, -1), torch.from_numpy(m), layer,
            k_scale=_torch(ks), v_scale=_torch(vs), **kw,
        )
        tol = dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else dict(atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(to_np(ours), to_np(ref), **tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    jd, td = DTYPES[dtype]
    x = (np.random.default_rng(5).normal(size=(3, 7, 4, HD)) * 3.0).astype(np.float32)
    x[0, 0, 1] = 0.0  # an all-zero head: scale 0, values 0
    j8, js = jda.quantize_kv(jnp.asarray(x, jd))
    t8, ts = tda.quantize_kv(torch.from_numpy(x).to(td))
    assert t8.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))
    assert (t8[0, 0, 1] == 0).all() and ts[0, 0, 1] == 0
    for out_dtype, jout in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        back = tda.dequantize_kv(t8, ts, dtype=out_dtype)
        assert back.dtype == out_dtype
        np.testing.assert_array_equal(to_np(back), to_np(jda.dequantize_kv(j8, js, dtype=jout)))


def test_wrapper_takes_the_twin_on_cpu():
    q, k, v = _inputs(4, 4, seed=6)
    q, k, v = (torch.from_numpy(x) for x in (q, k.reshape(L, B, S, -1), v.reshape(L, B, S, -1)))
    k8, ks = tda.quantize_kv(k.reshape(L, B, S, 4, HD))
    v8, vs = tda.quantize_kv(v.reshape(L, B, S, 4, HD))
    m = torch.from_numpy(_ragged_mask(7))
    fn = tda.decode_attention_stacked
    before = (fn.launches_bf16, fn.launches_int8)
    kw = dict(num_heads=4, head_dim=HD)
    torch.testing.assert_close(
        fn(q, k, v, m, 2, **kw), tda.decode_attention_stacked_reference(q, k, v, m, 2, **kw),
        rtol=0, atol=0,
    )
    k8, v8 = k8.reshape(L, B, S, -1), v8.reshape(L, B, S, -1)
    torch.testing.assert_close(
        fn(q, k8, v8, m, 0, k_scale=ks, v_scale=vs, **kw),
        tda.decode_attention_stacked_reference(q, k8, v8, m, 0, k_scale=ks, v_scale=vs, **kw),
        rtol=0, atol=0,
    )
    # the counters count kernel launches only
    assert (fn.launches_bf16, fn.launches_int8) == before


def test_wrapper_refuses_bad_arguments():
    q = torch.zeros(B, 4 * HD)
    k = torch.zeros(L, B, S, 4 * HD)
    m = torch.ones(B, S, dtype=torch.int32)
    kw = dict(num_heads=4, head_dim=HD)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tda.decode_attention_stacked(q.to("meta"), k.to("meta"), k.to("meta"), m.to("meta"), 0, **kw)
    with pytest.raises(ValueError, match="out of range"):
        tda.decode_attention_stacked(q, k, k, m, L, **kw)
    with pytest.raises(ValueError, match="mask"):
        tda.decode_attention_stacked(q, k, k, m[:, :-1], 0, **kw)
    with pytest.raises(ValueError, match="do not fit"):
        tda.decode_attention_stacked(q, k, k, m, 0, num_heads=2, head_dim=HD)
    with pytest.raises(ValueError, match="k_scale"):  # an int8 cache needs its scales
        tda.decode_attention_stacked(q, k.to(torch.int8), k.to(torch.int8), m, 0, **kw)


def test_smem_bound_matches_the_kernel_layout():
    # scores + query + PV partials + reduction scratch, in fp32
    assert tda.smem_bytes(798, 80) == 4 * (798 + 80 + 256 * 8 + 32)
    # int8, one block of a cluster of 3: its 266 scores and keep bits (9
    # words), 8 warps' PV partials, 8 ranks' partial outputs, reduction
    # scratch, 8 maxima and sums
    assert tda.split_smem_bytes(798, 80, 3) == 4 * (266 + 9 + 8 * 80 + 8 * 80 + 8 + 16)
    # the text LM's decode (cluster of 8): 256 scores, 8 words of bits
    assert tda.split_smem_bytes(2048, 128, 8) == 4 * (256 + 8 + 8 * 128 + 8 * 128 + 8 + 16)
    # the flagship shape fits; an S of 60k slots does not
    assert tda.split_smem_bytes(798, 80, tda.cluster_size(4, 32, 798)) <= tda.SMEM_LIMIT
    assert tda.smem_bytes(60_000, 128) > tda.SMEM_LIMIT
    # int8: the limit moves with the cluster: 60k slots fit a cluster of 8
    # (B * H < 33) and not a single block (B * H >= 264)
    assert tda.split_smem_bytes(60_000, 128, tda.cluster_size(1, 32, 60_000)) <= tda.SMEM_LIMIT
    assert tda.split_smem_bytes(60_000, 128, tda.cluster_size(2, 132, 60_000)) > tda.SMEM_LIMIT
    assert tda.split_smem_bytes(500_000, 128, 8) > tda.SMEM_LIMIT


# (B, H, S) -> the cluster size of K4: the smallest C with B * H * C >= 264
# (2 x 132 SMs), capped at 8 and at the number of 32-slot chunks
CLUSTER_RULE = [
    ((1, 32, 2048), 8),   # the text LM's decode: 9 wanted, capped at 8
    ((4, 32, 798), 3),    # the narration's decode
    ((1, 32, 1), 1), ((1, 32, 5), 1), ((1, 32, 32), 1), ((1, 32, 33), 2),  # S < a cluster's chunks
    ((1, 8, 100), 4),     # capped at ceil(100 / 32) chunks
    ((1, 1, 40), 2),
    ((2, 64, 1000), 3),
    ((1, 263, 4096), 2),
    ((1, 264, 4096), 1), ((2, 132, 4096), 1), ((3, 100, 4096), 1),  # B * H >= 264: one block
]


@pytest.mark.parametrize("shape,want", CLUSTER_RULE)
def test_cluster_size_rule(shape, want):
    assert tda.cluster_size(*shape) == want


@pytest.mark.parametrize("cache", ["fp32", "int8"])
@pytest.mark.parametrize("layout", ["opt", "gqa"])
def test_fp32_fully_masked_row_is_uniform(layout, cache):
    """An fp32 model: finfo(float32).min is finite, so a row with every slot
    masked is the uniform average of its S value rows (dequantized to fp32
    for the int8 cache), in the JAX kernel and in the twin."""
    nh, kvh, scale_query = LAYOUTS[layout]
    q, k, v = _inputs(nh, kvh, seed=8)
    m = _ragged_mask(9, fully_masked_row=True)
    kw = dict(num_heads=nh, head_dim=HD, kv_heads=kvh, scale_query=scale_query)
    if cache == "int8":
        k8, ks = jda.quantize_kv(jnp.asarray(k))
        v8, vs = jda.quantize_kv(jnp.asarray(v))
        jargs = (k8.reshape(L, B, S, -1), v8.reshape(L, B, S, -1))
        jkw = dict(k_scale=ks, v_scale=vs)
        targs = (_torch(k8).reshape(L, B, S, -1), _torch(v8).reshape(L, B, S, -1))
        tkw = dict(k_scale=_torch(ks), v_scale=_torch(vs))
        v_rows = to_np(tda.dequantize_kv(_torch(v8), _torch(vs), torch.float32))
    else:
        jargs = (jnp.asarray(k.reshape(L, B, S, -1)), jnp.asarray(v.reshape(L, B, S, -1)))
        targs = (torch.from_numpy(k.reshape(L, B, S, -1)), torch.from_numpy(v.reshape(L, B, S, -1)))
        jkw, tkw, v_rows = {}, {}, v
    group = nh // kvh
    for layer in range(L):
        ref = to_np(jda.decode_attention_stacked(jnp.asarray(q), *jargs, jnp.asarray(m), layer,
                                                 interpret=True, **jkw, **kw))
        ours = to_np(tda.decode_attention_stacked_reference(torch.from_numpy(q), *targs, torch.from_numpy(m),
                                                             layer, **tkw, **kw))
        # head h reads kv head h // group: the mean over S of that head's V rows
        want = np.repeat(v_rows[layer, 1].mean(0), group, axis=0).reshape(-1)
        np.testing.assert_allclose(ours[1], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ref[1], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


# (B, H, S) -> the bf16 K3 body: the split while one block per (head, row)
# would leave at least half of the 132 SMs idle (2 * B * H <= 132), one block
# per (head, row) from there
K3_BODY_RULE = [
    ((1, 32, 2048), True),   # the text LM's decode
    ((1, 32, 798), True),    # the narration's decode at batch 1
    ((4, 32, 798), False),   # the narration's decode at batch 4 (128 blocks)
    ((2, 32, 798), True), ((1, 66, 100), True), ((2, 33, 5), True), ((1, 1, 1), True),
    ((1, 67, 100), False), ((2, 34, 100), False), ((8, 32, 798), False),
]


@pytest.mark.parametrize("shape,split", K3_BODY_RULE)
def test_k3_body_rule(shape, split):
    assert tda.k3_split(*shape) is split


def _meta_call(b, nh, hd, s, q_dtype, cache_dtype):
    q = torch.empty(b, nh * hd, dtype=q_dtype, device="meta")
    k = torch.empty(2, b, s, nh * hd, dtype=cache_dtype, device="meta")
    return q, k


# (B, H, hd, S, query dtype, cache dtype) -> (body, cluster, shared memory a
# block needs): an fp32 model takes the fp32 body (streamed here: 8 + 8
# (max, sum) pairs, reduction scratch, 8 warps' and 8 ranks' partial outputs,
# keep bits, int8 scales, the kept slots' indices and a count a word); a bf16
# model over int8 the split; bf16 the split where k3_split says
BODY_TABLE = [
    ((1, 32, 128, 2048, torch.bfloat16, torch.bfloat16), ("split", 8, 4 * (256 + 8 + 8 * 128 + 8 * 128 + 8 + 16))),
    ((4, 32, 80, 798, torch.bfloat16, torch.bfloat16), ("one_block", 1, 4 * (798 + 80 + 256 * 8 + 32))),
    ((4, 32, 80, 798, torch.float32, torch.float32), ("f32", 2, 8 * 16 + 4 * (8 + 16 * 80 + 13) + 4 * (13 + 400))),
    ((1, 32, 80, 798, torch.bfloat16, torch.bfloat16), ("split", 8, 4 * (100 + 4 + 8 * 80 + 8 * 80 + 8 + 16))),
    ((8, 32, 80, 798, torch.bfloat16, torch.bfloat16), ("one_block", 1, 4 * (798 + 80 + 256 * 8 + 32))),
    ((8, 32, 80, 798, torch.float32, torch.float32), ("f32", 1, 8 * 16 + 4 * (8 + 16 * 80 + 25) + 4 * (25 + 800))),
    ((1, 32, 128, 2048, torch.float32, torch.float32), ("f32", 8, 8 * 16 + 4 * (8 + 16 * 128 + 8) + 4 * (8 + 256))),
    ((1, 32, 128, 2048, torch.float32, torch.int8), ("f32", 8, 8 * 16 + 4 * (8 + 16 * 128 + 8 + 512) + 4 * (8 + 256))),
    ((8, 32, 80, 798, torch.bfloat16, torch.int8), ("split", 2, 4 * (399 + 13 + 8 * 80 + 8 * 80 + 8 + 16))),
]


@pytest.mark.parametrize("case,want", BODY_TABLE)
def test_decode_body_cluster_and_shared_memory(case, want):
    """Which body a CUDA call takes, its cluster and the shared memory one
    block needs (what _check_cuda holds to the 227 KB limit), on meta
    tensors."""
    b, nh, hd, s, q_dtype, cache_dtype = case
    q, k = _meta_call(b, nh, hd, s, q_dtype, cache_dtype)
    assert tda.decode_body(q, k, hd) == want
    assert tda.uses_split(q, k, hd) is (want[0] != "one_block")


# (B, H, S, hd, int8 cache) -> (cluster, staged, shared memory a block) of
# the fp32 body (its cluster: f32_cluster_size): K and V are staged where a block with them keeps within
# 76,800 bytes (an SM's 228 KB over the 3 blocks its registers allow, less 1
# KB each), else streamed. A block takes n = f32_slots(S, C) slots at most
# (groups of 8, every C-th). Staged adds n rows of K at an odd number of
# 16-byte chunks (fp32 at D = 80: 21 chunks, 84 floats) and of V, the query
# and n scores; streamed the n kept slots' indices and a count a word; int8
# 2n scales either way
F32_RULE = [
    ((1, 32, 798, 80, False), (8, True, 128 + 104 * (84 + 80) * 4 + 4 * (104 + 80) + 4 * (8 + 16 * 80 + 4))),
    ((1, 32, 798, 80, True), (8, True, 128 + 104 * (80 + 80) + 4 * (104 + 80) + 4 * (8 + 16 * 80 + 4 + 208))),
    ((4, 32, 798, 80, False), (2, False, 128 + 4 * (8 + 16 * 80 + 13) + 4 * (13 + 400))),  # narration b4
    ((4, 32, 798, 80, True), (2, True, 128 + 400 * (80 + 80) + 4 * (400 + 80) + 4 * (8 + 16 * 80 + 13 + 800))),
    ((1, 32, 2048, 128, False), (8, False, 128 + 4 * (8 + 16 * 128 + 8) + 4 * (8 + 256))),  # the text LM
    ((1, 32, 2048, 128, True), (8, False, 128 + 4 * (8 + 16 * 128 + 8 + 512) + 4 * (8 + 256))),
    ((4, 32, 2048, 80, False), (2, False, 128 + 4 * (8 + 16 * 80 + 32) + 4 * (32 + 1024))),  # the serving cache
    ((4, 32, 2048, 80, True), (2, False, 128 + 4 * (8 + 16 * 80 + 32 + 2048) + 4 * (32 + 1024))),
    # int8 at D = 128 (K rows of 144 bytes): 232 slots a block (29 groups of 8) are the most staged
    ((1, 32, 1856, 128, True), (8, True, 128 + 232 * (144 + 128) + 4 * (232 + 128) + 4 * (8 + 16 * 128 + 8 + 464))),
    ((1, 32, 1857, 128, True), (8, False, 128 + 4 * (8 + 16 * 128 + 8 + 480) + 4 * (8 + 240))),
    ((2, 3, 37, 8, False), (2, True, 128 + 24 * (12 + 8) * 4 + 4 * (24 + 8) + 4 * (8 + 16 * 8 + 1))),  # D = 8
]


# (B, H, S) -> the fp32 body's cluster: cluster_size's, lowered while the B *
# H clusters would not fit one wave (F32_WAVE_CLUSTERS: 124 of 3 blocks, 198
# of 2, 45 of 8)
F32_CLUSTER_RULE = [
    ((1, 32, 2048), 8), ((1, 32, 798), 8), ((1, 16, 798), 8),  # the text LM, the narration at b1, TP = 2
    ((4, 32, 798), 2), ((5, 32, 798), 2), ((4, 32, 2048), 2),  # narration b4, beam-5 b1, the serving cache
    ((1, 124, 4096), 3), ((1, 125, 4096), 2),
    ((20, 32, 798), 1), ((1, 32, 5), 1),
]


@pytest.mark.parametrize("shape,want", F32_CLUSTER_RULE)
def test_f32_cluster_rule(shape, want):
    assert tda.f32_cluster_size(*shape) == want


@pytest.mark.parametrize("shape,want", F32_RULE)
def test_f32_body_rule(shape, want):
    b, nh, s, hd, int8 = shape
    cluster = tda.f32_cluster_size(b, nh, s)
    staged = tda.f32_staged(b, nh, s, hd, int8)
    assert (cluster, staged, tda.f32_smem_bytes(s, hd, cluster, int8, staged)) == want


def test_f32_body_refuses_exactly_what_its_shared_memory_cannot_hold():
    """Streamed, the fp32 body keeps an index and a keep bit a slot, and over
    an int8 cache two scales: at B = 1, H = 2, hd = 16 (a cluster of 8) S =
    150,976 (18,872 slots a block) fits 227 KB over int8 and 150,977 (18,880)
    does not; over fp32 435,264 (54,408) fits and 435,265 (54,416) does not.
    _check_cuda refuses exactly there, on meta tensors."""
    q = torch.empty(1, 32, device="meta")
    for int8, s, fits in ((True, 150_976, True), (True, 150_977, False), (False, 435_264, True), (False, 435_265, False)):
        assert (tda.f32_smem_bytes(s, 16, tda.f32_cluster_size(1, 2, s), int8, False) <= tda.SMEM_LIMIT) is fits
        m = torch.empty(1, s, dtype=torch.int32, device="meta")
        k = torch.empty(1, 1, s, 32, dtype=torch.int8 if int8 else torch.float32, device="meta")
        sc = torch.empty(1, 1, s, 2, dtype=torch.bfloat16, device="meta") if int8 else None
        if fits:
            tda._check_cuda(q, k, k, m, sc, sc, 16, s)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                tda._check_cuda(q, k, k, m, sc, sc, 16, s)


def test_cuda_check_takes_bf16_and_fp32_models():
    """The CUDA kernel's checks, read on CPU tensors (no launch): a bf16 or
    fp32 query over a cache of its dtype or int8; fp16 and mixed dtypes
    raise; the shared-memory need follows the body the rule picks."""
    m = torch.ones(1, 40, dtype=torch.int32)
    sc = torch.ones(2, 1, 40, 2, dtype=torch.bfloat16)
    for q_dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 32, dtype=q_dtype)
        k = torch.zeros(2, 1, 40, 32, dtype=q_dtype)
        tda._check_cuda(q, k, k, m, None, None, 16, 40)
        k8 = torch.zeros(2, 1, 40, 32, dtype=torch.int8)
        tda._check_cuda(q, k8, k8, m, sc, sc, 16, 40)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        k16 = torch.zeros(2, 1, 40, 32, dtype=torch.float16)
        tda._check_cuda(torch.zeros(1, 32, dtype=torch.float16), k16, k16, m, None, None, 16, 40)
    with pytest.raises(TypeError, match="bf16 or fp32"):  # an fp32 query over a bf16 cache
        kb = torch.zeros(2, 1, 40, 32, dtype=torch.bfloat16)
        tda._check_cuda(torch.zeros(1, 32), kb, kb, m, None, None, 16, 40)
    # the one-block body (2 * B * H > 132) keeps every score in one block: 60k
    # slots do not fit; the split (here B * H = 2) spreads them over 8 blocks
    s_big = 60_000
    assert tda.smem_bytes(s_big, 16) > tda.SMEM_LIMIT
    assert tda.split_smem_bytes(s_big, 16, tda.cluster_size(1, 2, s_big)) <= tda.SMEM_LIMIT
