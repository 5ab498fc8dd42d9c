"""Port vs JAX: the continuous-batching engine in the int8 serving modes,
plain and prompt-lookup speculative, in the fp32 ``tiny_config`` world of
``tests/_torch_serving.py`` (the float tree quantized by the JAX package's
functions and loaded into both packages).

Each of ``int8_lm``, ``int8_lm + int8_kv``, ``w8a8_prefill`` (with
``int8_lm``) and ``int8_vision``: every engine row is token-identical to
JAX's isolated ``generate`` of the request in the same mode. One request's
admission (a 74-token prompt in a 16-token bucket: 80 rows) is longer than
64 rows, so the W8A8 prefill path dispatches there; a recorder on the
port's W8A8 product shows that it did (and, under ``int8_lm`` alone, that
nothing runs W8A8).
"""

import dataclasses

import pytest

from eilev_tpu_torch.ops import quantization as tq

from ._torch_serving import assert_rows, engine, make_world, reference_rows

GEN = dict(max_new_tokens=6, pad_token_id=1)
MODES = {
    "int8_lm": dict(int8_lm=True),
    "int8_lm_kv": dict(int8_lm=True, int8_kv=True),
    "w8a8_prefill": dict(int8_lm=True, w8a8_prefill=True),
    "int8_vision": dict(int8_vision=True),
}
_WORLDS: dict = {}


def _world(mode: str):
    if mode not in _WORLDS:
        _WORLDS[mode] = make_world("opt", modes=MODES[mode])
    return _WORLDS[mode]


@pytest.mark.parametrize("speculative", [None, "prompt_lookup"], ids=["plain", "prompt_lookup"])
@pytest.mark.parametrize("mode", list(MODES))
def test_int8_engine_rows_identical_to_jax_generate(mode, speculative, monkeypatch):
    w = _world(mode)
    # 14, 16 and 74 prompt tokens: the last admission prefills 80 rows
    requests = [w.make_request(0), w.make_request(1, extra_text=2), w.make_request(2, extra_text=60)]
    ref = reference_rows(w, requests, **GEN)
    w8a8_rows = []
    inner = tq._w8a8_f32

    def recording(x2d, w8):
        w8a8_rows.append(x2d.shape[0])
        return inner(x2d, w8)

    monkeypatch.setattr(tq, "_w8a8_f32", recording)
    kw = dict(max_slots=2, max_len=128, prefill_bucket=16)
    if speculative:
        kw.update(speculative=speculative, spec_gamma=4, spec_match_len=2)
    eng = engine(w, GEN, **kw)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    if mode == "w8a8_prefill":
        assert w8a8_rows and min(w8a8_rows) >= 64 and max(w8a8_rows) >= 80, w8a8_rows
    if mode.startswith("int8_lm"):
        assert not w8a8_rows
    if mode == "int8_vision":
        assert w8a8_rows  # the vision tower's W8A8 layers ran
    if speculative:
        assert eng.stats["spec_passes"] > 0
