"""Text-only LM generation (counterpart of ``eilev_tpu/generation/text_lm.py``).

Drives a bare decoder-only LM through the same decoding loop as VideoBLIP. The
reference's sentence-ification utilities run Llama-2-chat; :class:`TextLM`
runs those recipes from local HF checkpoints, LLaMA-family (``models/llama.py``)
or OPT-family (``models/opt.py``), with greedy, sampling (and
``num_return_sequences``), the logits processors, beam search
(``generation/decoding.py``) and speculative decoding: prompt lookup
(greedy and sampling) and self-drafting by the first layers (greedy;
``generation/speculative.py``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..configs import LlamaConfig, VideoBlipConfig
from ..models.convert import convert_llama, convert_opt, llama_config_from_hf, opt_config_from_hf
from ..models.llama import LlamaForCausalLM
from ..models.opt import OPTForCausalLM
from .config import GenerationConfig
from .decoding import _decode, _resolve_lengths, _speculative, _validate_num_return_sequences


class _TextOnlyModule(nn.Module):
    """The VideoBLIP method surface the decoding loop uses, over a bare LM."""

    def __init__(self, config: VideoBlipConfig, *, device=None, dtype=None, tp=None):
        super().__init__()
        self.config = config  # text_config is what matters
        lm_cls = LlamaForCausalLM if isinstance(config.text_config, LlamaConfig) else OPTForCausalLM
        self.language_model = lm_cls(config.text_config, tp=tp, device=device, dtype=dtype)
        self.tp = self.language_model.tp

    def embed_and_scatter(self, input_ids, pixel_values=None, video_input_mask=None):
        del pixel_values, video_input_mask
        return self.language_model.embed(input_ids)

    def lm_embed(self, input_ids):
        return self.language_model.embed(input_ids)

    def lm_forward(self, inputs_embeds, attention_mask=None, cache=None, cache_append=False):
        return self.language_model(
            inputs_embeds, attention_mask=attention_mask, cache=cache, cache_append=cache_append
        )


def load_tokenizer(path: str):
    """HF tokenizer from a local directory (``eilev_tpu/models/auto.py:load_tokenizer``)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _pad_1d(arr: np.ndarray, target: int, value: int, side: str) -> np.ndarray:
    """``arr`` padded with ``value`` to ``target`` on ``side`` (``eilev_tpu/data/collate.py``)."""
    pad = target - len(arr)
    if pad <= 0:
        return np.asarray(arr)
    filler = np.full(pad, value, dtype=np.asarray(arr).dtype)
    if side == "right":
        return np.concatenate([arr, filler])
    return np.concatenate([filler, arr])


class TextLM:
    """Load a local HF decoder-only causal LM directory (LLaMA- or OPT-family)
    and generate text."""

    def __init__(
        self,
        path: str,
        dtype: torch.dtype = torch.bfloat16,
        int8: bool = False,
        int8_kv: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        """Reads ``config.json`` and ``*.safetensors`` from ``path``. The model
        goes to ``device`` (the card unless the caller asks for the CPU).
        ``int8=True`` quantizes the LM's projection and FFN matmuls to int8
        weights (``ops/quantization.py``); ``int8_kv=True`` stores the KV cache
        in int8, read by kernel K4 on every decode step."""
        from ..models.safetensors_io import load_file
        from ..ops.quantization import quantize_model_

        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        model_type = hf.get("model_type")
        if model_type == "llama":
            text_cfg = llama_config_from_hf(hf)
            convert = convert_llama
        elif model_type == "opt":
            text_cfg = opt_config_from_hf(hf)
            convert = convert_opt
        else:
            raise ValueError(
                "TextLM supports LLaMA- and OPT-family decoder-only checkpoints; "
                f"got {model_type!r}."
            )
        self.config = VideoBlipConfig(text_config=text_cfg)
        self.device = torch.device(device)
        self.module = _TextOnlyModule(self.config, device=self.device, dtype=dtype).eval()
        tensors: dict = {}
        for fpath in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
            tensors.update(load_file(fpath))
        self.module.language_model.load_state_dict(convert(tensors, text_cfg), strict=True)
        if int8 or int8_kv:
            quantize_model_(self.module, int8_lm=int8, int8_kv=int8_kv)
            self.config = self.module.config
        self.tokenizer = load_tokenizer(path)

    @classmethod
    def _from_parts(cls, module: _TextOnlyModule, tokenizer) -> "TextLM":
        """A TextLM over an already built text-only ``module`` and a
        ``tokenizer``, without a checkpoint directory or ``transformers``."""
        lm = cls.__new__(cls)
        lm.module, lm.config, lm.tokenizer = module, module.config, tokenizer
        lm.device = next(module.parameters()).device
        return lm

    @torch.inference_mode()
    def generate(
        self,
        prompts: list[str],
        generation_config: Optional[GenerationConfig] = None,
        generator: Optional[torch.Generator] = None,
        draft_layers: int = 0,
        draft_tokens: int = 4,
        draft: Optional[str] = None,
        draft_match_len: int = 3,
    ) -> list[str]:
        """Continue each prompt (left-padded into one batch): beam search when
        ``num_beams > 1``; else ``draft="prompt_lookup"`` (model-free
        speculative decoding over the prompts' n-grams, greedy or sampling),
        ``draft_layers > 0`` (greedy, the first N layers drafting
        ``draft_tokens`` tokens a verify pass; token-identical to greedy), or
        greedy or sampled decoding, with the logits processors. ``generator``
        (where JAX takes ``rng``) feeds the sampling draws and must be on the
        model's device (another raises ``ValueError``); with none, a
        generator there seeded with 0. Returns ``num_return_sequences`` texts
        a prompt, interleaved.

        The processors see the generated tokens only, as in JAX (the loops
        drive the LM through inputs_embeds, where HF starts from an empty
        input_ids).
        """
        gen_cfg = generation_config or GenerationConfig(max_new_tokens=64)
        if gen_cfg.eos_token_id is None:
            gen_cfg = gen_cfg.with_eos(self.config.text_config.eos_token_id)
        _validate_num_return_sequences(gen_cfg)
        enc = [self.tokenizer(t)["input_ids"] for t in prompts]
        longest = max(len(e) for e in enc)
        ids = np.stack(
            [_pad_1d(np.asarray(e), longest, self.tokenizer.pad_token_id, "left") for e in enc]
        )
        mask = np.stack([_pad_1d(np.ones(len(e), np.int64), longest, 0, "left") for e in enc])
        ids = torch.from_numpy(ids).to(self.device)
        embeds = self.module.embed_and_scatter(ids)
        mask = torch.from_numpy(mask).to(self.device)
        # HF counts min_length/max_length over prompt + generated on the
        # inputs_embeds path
        gen_cfg = _resolve_lengths(gen_cfg, start_len=embeds.shape[1])
        if draft is not None and draft != "prompt_lookup":
            raise ValueError(f"unknown draft strategy {draft!r}; supported: 'prompt_lookup'")
        tokens = None
        if gen_cfg.num_beams == 1:
            tokens = _speculative(
                self.module.language_model, ids, None, embeds, mask, gen_cfg, generator,
                draft, draft_layers, draft_tokens, draft_match_len, None)
        if tokens is None:
            tokens = _decode(self.module, embeds, mask, gen_cfg, generator)
        return self.tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)
