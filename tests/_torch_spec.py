"""The tiny VideoBLIP-OPT world of the port's generation-mode tests
(speculative, prompt lookup, contrastive search, streaming): a 4-layer
``tiny_config`` model in both packages on the same numpy weights, 2 rows of
2 videos each with row 0 left-padded, as ``tests/generation/``'s tests set
it up. The weights (std 0.5, seed 3) make greedy text that varies from
token to token, so drafts are accepted and rejected."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax

from ._torch_port import random_params


def tiny_world(int8_kv: bool = False) -> SimpleNamespace:
    cfg = configs.tiny_config(text_model="opt", layers=4)
    tcfg = tconfigs.tiny_config(text_model="opt", layers=4)
    if int8_kv:
        cfg = configs.replace(cfg, text_config=configs.replace(cfg.text_config, int8_kv_cache=True))
        tcfg = tconfigs.replace(tcfg, text_config=tconfigs.replace(tcfg.text_config, int8_kv_cache=True))
    rng = np.random.default_rng(0)
    b, v, t, s = 2, 2, 2, 18
    img = cfg.vision_config.image_size
    pixel = rng.normal(size=(b * v, 3, t, img, img)).astype(np.float32)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    ids[0, :2], mask[0, :2] = 1, 0  # left padding on row 0
    vim = np.zeros((b, s), np.int32)
    vim[:, 3 : 3 + v * cfg.num_query_tokens] = 1
    jmodel = JVB(cfg)
    params = random_params(
        jmodel, 3, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
        video_input_mask=jnp.asarray(vim), std=0.5,
    )
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return SimpleNamespace(cfg=cfg, tcfg=tcfg, jmodel=jmodel, params=params, model=model.eval(), ids=ids,
                           mask=mask, vim=vim, pixel=pixel, pad=cfg.text_config.pad_token_id)


def _inputs(w, rows):
    """The numpy inputs of the rows ``rows`` (a slice) and their videos."""
    v = w.pixel.shape[0] // w.ids.shape[0]
    vids = slice(None) if rows == slice(None) else slice(rows.start * v, rows.stop * v)
    return dict(input_ids=w.ids[rows], attention_mask=w.mask[rows], pixel_values=w.pixel[vids],
                video_input_mask=w.vim[rows])


def jax_inputs(w, rows=slice(None)):
    return {k: jnp.asarray(val) for k, val in _inputs(w, rows).items()}


def port_inputs(w, rows=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(val)) for k, val in _inputs(w, rows).items()}


def jax_tokens(w, gen: dict, rows=slice(None), **kw) -> np.ndarray:
    cfg = JGenerationConfig(pad_token_id=w.pad, **gen)
    return np.asarray(jgenerate(w.jmodel, {"params": w.params}, generation_config=cfg, **jax_inputs(w, rows), **kw))


def port_tokens(w, gen: dict, rows=slice(None), **kw) -> np.ndarray:
    cfg = GenerationConfig(pad_token_id=w.pad, **gen)
    return generate(w.model, generation_config=cfg, **port_inputs(w, rows), **kw).numpy()
