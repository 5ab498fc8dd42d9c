"""Port vs JAX: ``ChatSession``, multi-turn chat with incremental prefill.

Mirrors ``tests/serving/test_session.py``: every reply, blocking or
streamed, equals JAX's from-scratch ``generate`` on the whole prompt so far
(fp32, token for token), whether the cached prefix is reused, rolled back
to the common prefix or reset; the session's bookkeeping (reuse, rolled
back, appended) is JAX's; a bf16 session crosses the fp32-logits /
model-dtype boundary of its streamed decode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.serving import ChatSession as JChatSession
from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.serving import ChatSession, Request

from ._torch_serving import make_world, reference_rows


@pytest.fixture(scope="module")
def world():
    w = make_world("opt")
    q, img = w.cfg.num_query_tokens, w.cfg.vision_config.image_size

    def make_video(seed):
        return np.random.default_rng(seed).normal(size=(1, 3, 2, img, img)).astype(np.float32)

    def make_turn(seed, n, with_video):
        r = np.random.default_rng(seed)
        ids = r.integers(4, w.cfg.text_config.vocab_size, size=(n,))
        vim = np.zeros((n,), np.int64)
        if with_video:
            vim[:q] = 1
        return ids, vim

    w.make_video, w.make_turn = make_video, make_turn
    return w


def _reference(w, gen, ids, videos, vim):
    """JAX's from-scratch generate on the whole prompt, trailing pads cut."""
    req = Request(input_ids=ids, pixel_values=videos, video_input_mask=vim if videos is not None else None)
    row = reference_rows(w, [req], **gen)[0]
    m = len(row)
    while m > 0 and row[m - 1] == gen["pad_token_id"]:
        m -= 1
    return row[:m]


def _sessions(w, gen, **kw):
    return (ChatSession(w.model, GenerationConfig(**gen), **kw),
            JChatSession(w.jmodel, w.variables, JGenerationConfig(**gen), **kw))


def test_session_multi_turn_matches_generate(world):
    """Three turns (new text, then a new video and text): every reply is the
    from-scratch generate's, with the prefix reused."""
    gen = dict(max_new_tokens=6, pad_token_id=1)
    sess, jsess = _sessions(world, gen, max_len=128, bucket=8)
    ids, vim = world.make_turn(1, 12, True)
    videos = world.make_video(1)
    for turn, (seed, n, with_video) in enumerate([(None, None, None), (2, 7, False), (3, 9, True)]):
        if turn > 0:
            extra_ids, extra_vim = world.make_turn(seed, n, with_video)
            ids, vim = np.concatenate([ids, extra_ids]), np.concatenate([vim, extra_vim])
            if with_video:
                videos = np.concatenate([videos, world.make_video(seed)])
        reply = sess.turn(ids, videos, vim)
        assert sess.reused_last_turn == (turn > 0)
        np.testing.assert_array_equal(reply, _reference(world, gen, ids, videos, vim), err_msg=f"turn {turn}")
        np.testing.assert_array_equal(reply, jsess.turn(ids, jnp.asarray(videos), vim))
        ids = np.concatenate([ids, reply.astype(ids.dtype)])
        vim = np.concatenate([vim, np.zeros((len(reply),), vim.dtype)])


def test_session_mid_stream_edit_rolls_back(world):
    """An edited mid-conversation token rolls the cache back to the common
    prefix, which is still reused; the counts are JAX's."""
    gen = dict(max_new_tokens=5, pad_token_id=1)
    sess, jsess = _sessions(world, gen, max_len=128, bucket=8)
    ids, vim = world.make_turn(10, 12, True)
    videos = world.make_video(10)
    reply = sess.turn(ids, videos, vim)
    np.testing.assert_array_equal(reply, jsess.turn(ids, jnp.asarray(videos), vim))
    ids = np.concatenate([ids, reply.astype(ids.dtype), [5, 6, 7]])
    vim = np.concatenate([vim, np.zeros((len(reply) + 3,), vim.dtype)])
    edit_at = len(ids) - len(reply) - 3  # the first reply token
    ids[edit_at] = (ids[edit_at] + 1) % 60 + 4
    reply2 = sess.turn(ids, videos, vim)
    jreply2 = jsess.turn(ids, jnp.asarray(videos), vim)
    assert sess.reused_last_turn and sess.last_turn_rolled_back == len(reply)
    assert sess.last_turn_appended == len(reply) + 3
    assert (sess.last_turn_rolled_back, sess.last_turn_appended) == (jsess.last_turn_rolled_back,
                                                                     jsess.last_turn_appended)
    np.testing.assert_array_equal(reply2, _reference(world, gen, ids, videos, vim))
    np.testing.assert_array_equal(reply2, jreply2)


def test_session_first_token_edit_resets(world):
    gen = dict(max_new_tokens=5, pad_token_id=1)
    sess = ChatSession(world.model, GenerationConfig(**gen), max_len=128, bucket=8)
    ids, vim = world.make_turn(11, 10, False)
    sess.turn(ids, None, vim)
    ids2 = ids.copy()
    ids2[0] = (ids2[0] + 1) % 60 + 4
    ids2 = np.concatenate([ids2, [8, 9]])
    vim2 = np.concatenate([vim, np.zeros((2,), vim.dtype)])
    reply = sess.turn(ids2, None, vim2)
    assert not sess.reused_last_turn
    np.testing.assert_array_equal(reply, _reference(world, gen, ids2, None, vim2))


def test_session_overflow_raises(world):
    sess = ChatSession(world.model, GenerationConfig(max_new_tokens=8, pad_token_id=1), max_len=16, bucket=8)
    ids, vim = world.make_turn(20, 12, True)
    with pytest.raises(ValueError, match="max_len"):
        sess.turn(ids, world.make_video(20), vim)


@pytest.mark.parametrize("knobs,error,match", [
    (dict(num_beams=3), ValueError, "greedy"),
    (dict(do_sample=True), ValueError, "greedy"),
    (dict(repetition_penalty=1.2), NotImplementedError, "repetition_penalty"),
])
def test_session_refusals(world, knobs, error, match):
    with pytest.raises(error, match=match):
        ChatSession(world.model, GenerationConfig(pad_token_id=1, **knobs))


def test_session_rejects_t5():
    w = make_world("t5")
    with pytest.raises(ValueError, match="decoder-only"):
        ChatSession(w.model, GenerationConfig(pad_token_id=0))


def test_session_turn_stream_matches_turn(world):
    """Streamed turns emit the blocking turns' tokens, and the pads a chunk
    appends past the eos are masked back out, so the next turn still reuses
    the stream."""
    probe = dict(max_new_tokens=6, pad_token_id=1)
    ids, vim = world.make_turn(30, 12, True)
    videos = world.make_video(30)
    # an eos the first reply emits mid-chunk (its third token)
    eos = int(_reference(world, probe, ids, videos, vim)[2])
    gen = dict(probe, eos_token_id=(eos,))
    blocking = ChatSession(world.model, GenerationConfig(**gen), max_len=128, bucket=8)
    streaming = ChatSession(world.model, GenerationConfig(**gen), max_len=128, bucket=8)
    for turn in range(3):
        if turn > 0:
            extra_ids, extra_vim = world.make_turn(31 + turn, 5, False)
            ids, vim = np.concatenate([ids, extra_ids]), np.concatenate([vim, extra_vim])
        ref = blocking.turn(ids, videos, vim)
        got = np.concatenate(list(streaming.turn_stream(ids, videos, vim, chunk=4)))
        np.testing.assert_array_equal(got, ref, err_msg=f"turn {turn}")
        np.testing.assert_array_equal(ref, _reference(world, gen, ids, videos, vim))
        assert streaming.reused_last_turn == (turn > 0)
        ids = np.concatenate([ids, ref.astype(ids.dtype)])
        vim = np.concatenate([vim, np.zeros((len(ref),), vim.dtype)])


def test_session_turn_stream_bf16_dtype_boundary():
    """bf16: the append's fp32 logits re-enter the model-dtype chunked
    decode; the streamed reply equals the blocking one."""
    w = make_world("opt", dtype=torch.bfloat16)
    q, img = w.cfg.num_query_tokens, w.cfg.vision_config.image_size
    r = np.random.default_rng(40)
    ids = r.integers(4, w.cfg.text_config.vocab_size, size=(12,))
    vim = np.zeros((12,), np.int64)
    vim[:q] = 1
    video = r.normal(size=(1, 3, 2, img, img)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=4, pad_token_id=1)
    chunks = list(ChatSession(w.model, gen, max_len=128, bucket=8).turn_stream(ids, video, vim, chunk=3))
    blocking = ChatSession(w.model, gen, max_len=128, bucket=8).turn(ids, video, vim)
    assert sum(len(c) for c in chunks) > 0
    np.testing.assert_array_equal(np.concatenate(chunks), blocking)
