"""The tiny worlds of the port's serving tests (tests/test_torch_serving*.py).

A ``tiny_config`` VideoBLIP-OPT or -T5 in both packages on the same numpy
weights (``random_params``, std 0.5 so greedy text varies from token to
token and drafts are accepted and rejected), and the requests of
``tests/serving/``: prompts of 14 + extra random tokens with one video
after the first token, made from a seeded numpy generator. The reference
for every engine row is JAX's isolated ``generate`` on the same request;
each request is converted to both packages' ``Request``.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.serving import ContinuousBatchingEngine as JEngine
from eilev_tpu.serving import Request as JRequest
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.serving import ContinuousBatchingEngine, Request

from ._torch_port import random_params

PROMPT = 14
FRAMES = 2


def _serving_modes(mod, cfg, modes: dict):
    """``cfg`` (either package's config module ``mod``) with the int8
    serving switches of ``modes`` on: ``int8_lm`` (weight-only int8 LM
    matmuls), ``int8_kv`` (the int8 KV cache), ``w8a8_prefill`` (W8A8 LM
    prefill matmuls past 64 rows), ``int8_vision`` (a W8A8 vision tower)."""
    if not modes:
        return cfg
    text = mod.replace(cfg.text_config, quantize_matmuls=modes.get("int8_lm", False),
                       int8_kv_cache=modes.get("int8_kv", False), w8a8_prefill=modes.get("w8a8_prefill", False))
    vision = mod.replace(cfg.vision_config, quantize_matmuls=modes.get("int8_vision", False))
    return mod.replace(cfg, text_config=text, vision_config=vision)


def make_world(text_model: str = "opt", seed: int = 3, dtype=None, modes: dict = None) -> SimpleNamespace:
    """Both packages' models on one numpy weight tree. ``dtype`` bf16 builds
    both at a bf16 compute over the fp32 weights (the JAX model's
    ``dtype``, the port's ``param_dtype=float32``). ``modes`` (see
    :func:`_serving_modes`) turns the int8 serving modes on: the float tree
    is quantized by the JAX package's functions and loaded into both."""
    from eilev_tpu.ops import quantization as jq

    modes = modes or {}
    float_cfg = configs.tiny_config(text_model=text_model)
    cfg = _serving_modes(configs, float_cfg, modes)
    tcfg = _serving_modes(tconfigs, tconfigs.tiny_config(text_model=text_model), modes)
    img, q = cfg.vision_config.image_size, cfg.num_query_tokens

    def make_request(rseed, extra_text=0, n_videos=1):
        r = np.random.default_rng(rseed)
        p = PROMPT + extra_text if n_videos == 1 else 6 + n_videos * (q + 1)
        ids = r.integers(4, cfg.text_config.vocab_size, size=(p,))
        if n_videos == 0:
            return Request(input_ids=ids, pixel_values=None, video_input_mask=None)
        vim = np.zeros((p,), np.int64)
        for i in range(n_videos):
            start = 1 + i * (q + 1)
            vim[start : start + q] = 1
        pixel = r.normal(size=(n_videos, 3, FRAMES, img, img)).astype(np.float32)
        return Request(input_ids=ids, pixel_values=pixel, video_input_mask=vim)

    first = make_request(0)
    extra = {"decoder_input_ids": jnp.zeros((1, 1), jnp.int32)} if text_model == "t5" else {}
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = JVB(cfg, dtype=jdtype)
    params = random_params(JVB(float_cfg), seed, input_ids=jnp.asarray(first.input_ids[None]),
                           pixel_values=jnp.asarray(first.pixel_values),
                           video_input_mask=jnp.asarray(first.video_input_mask[None]), std=0.5, **extra)
    params = dict(jax.tree.map(np.asarray, params))
    if modes.get("int8_lm"):
        params["language_model"] = jq.quantize_lm_params(params["language_model"])
    if modes.get("int8_vision"):
        params["vision_model"] = jq.quantize_vision_params(params["vision_model"])
    params = jax.tree.map(np.asarray, params)
    kw = {} if dtype is None else {"dtype": dtype, "param_dtype": torch.float32}
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu", **kw)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    model.requires_grad_(False).eval()
    pad = cfg.text_config.pad_token_id if text_model == "t5" else 1
    return SimpleNamespace(cfg=cfg, jmodel=jmodel, variables={"params": params}, model=model,
                           make_request=make_request, pad=pad, t5=text_model == "t5")


def to_jax(req: Request) -> JRequest:
    return JRequest(**{f.name: getattr(req, f.name) for f in dataclasses.fields(JRequest)})


def gen_configs(**kw):
    """The same generation config in both packages."""
    return JGenerationConfig(**kw), GenerationConfig(**kw)


_REFERENCE: dict = {}


def reference_rows(w, requests, **gen_kw) -> list:
    """JAX's isolated ``generate`` of each request, as engine rows: the new
    tokens (T5: after the start token), pad-filled to max_new_tokens. Rows
    are kept by world, request and config, so a case that asks again reuses
    them."""
    jcfg, _ = gen_configs(**gen_kw)
    rows = []
    for r in requests:
        key = (id(w), r.input_ids.tobytes(), None if r.pixel_values is None else r.pixel_values.tobytes(),
               tuple(sorted(gen_kw.items())))
        if key in _REFERENCE:
            rows.append(_REFERENCE[key])
            continue
        kw = {"input_ids": jnp.asarray(r.input_ids[None]), "generation_config": jcfg}
        if r.pixel_values is not None:
            kw.update(pixel_values=jnp.asarray(r.pixel_values),
                      video_input_mask=jnp.asarray(r.video_input_mask[None]))
        out = np.asarray(jgenerate(w.jmodel, w.variables, **kw))[0]
        if w.t5:
            out = out[1:]
        row = np.full((jcfg.max_new_tokens,), jcfg.pad_token_id, np.int32)
        row[: len(out)] = out
        rows.append(_REFERENCE.setdefault(key, row))
    return rows


def engine(w, gen_kw: dict, **kw) -> ContinuousBatchingEngine:
    return ContinuousBatchingEngine(w.model, GenerationConfig(**gen_kw), **kw)


def jax_engine(w, gen_kw: dict, **kw) -> JEngine:
    return JEngine(w.jmodel, w.variables, JGenerationConfig(**gen_kw), **kw)


def drive_topped_up(eng, requests, depth: int = 2, first_alone: bool = False, limit: int = 300) -> dict:
    """Keep ``depth`` requests queued while any remain (so slots never all
    drain); ``first_alone`` runs one step with only the first request.
    Returns {rid: Completion}."""
    done, pending, steps = {}, [dataclasses.replace(r) for r in requests], 0
    if first_alone:
        eng.submit(pending.pop(0))
        done.update((c.rid, c) for c in eng.step())
    while pending or not eng.idle:
        while pending and len(eng._queue) < depth:
            eng.submit(pending.pop(0))
        done.update((c.rid, c) for c in eng.step())
        steps += 1
        assert steps < limit
    return done


def assert_rows(done: dict, ref: list) -> None:
    assert sorted(done) == list(range(len(ref)))
    for rid, row in enumerate(ref):
        np.testing.assert_array_equal(done[rid].tokens, row, err_msg=str(rid))
