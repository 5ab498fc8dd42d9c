"""Port vs JAX: TextLM (generation/text_lm.py) on tiny HF checkpoints built in
the test, LLaMA (GQA) and OPT, in fp32: the same greedy tokens and texts as
``eilev_tpu.generation.text_lm.TextLM``, also with ``int8 + int8_kv``; the
converters map every HF weight; speculative decoding gives JAX's texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation.decoding import _greedy_sample_decoder_only as j_greedy
from eilev_tpu.generation.text_lm import TextLM as JTextLM
from eilev_tpu_torch.generation import GenerationConfig, TextLM
from eilev_tpu_torch.generation.decoding import _greedy_sample_decoder_only
from eilev_tpu_torch.generation.text_lm import _pad_1d

from .util_tokenizer import build_tiny_tokenizer

PROMPTS = ["[INST] Generate a sentence [/INST]", "cut onion",
           "The camera wearer opens a drawer and takes a knife"]


@pytest.fixture(scope="module")
def llama_checkpoint(tmp_path_factory):
    from transformers import LlamaConfig as HFLlamaConfig, LlamaForCausalLM

    d = str(tmp_path_factory.mktemp("llama_ckpt"))
    cfg = HFLlamaConfig(
        vocab_size=384, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).eval().save_pretrained(d, safe_serialization=True)
    build_tiny_tokenizer(d, vocab_size=384)
    return d


@pytest.fixture(scope="module")
def opt_checkpoint(tmp_path_factory):
    from transformers import OPTConfig as HFOPTConfig, OPTForCausalLM

    d = str(tmp_path_factory.mktemp("opt_ckpt"))
    cfg = HFOPTConfig(
        vocab_size=384, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        ffn_dim=32, max_position_embeddings=128, word_embed_proj_dim=16,
        dropout=0.0, attention_dropout=0.0,
    )
    torch.manual_seed(0)
    OPTForCausalLM(cfg).eval().save_pretrained(d, safe_serialization=True)
    build_tiny_tokenizer(d, vocab_size=384)
    return d


def _batch(tokenizer, prompts):
    enc = [tokenizer(t)["input_ids"] for t in prompts]
    longest = max(len(e) for e in enc)
    ids = np.stack([_pad_1d(np.asarray(e), longest, tokenizer.pad_token_id, "left") for e in enc])
    mask = np.stack([_pad_1d(np.ones(len(e), np.int64), longest, 0, "left") for e in enc])
    return ids, mask


@pytest.mark.parametrize("family", ["llama", "opt"])
@pytest.mark.parametrize("int8", [False, True])
def test_text_lm_greedy_matches_jax(request, family, int8):
    path = request.getfixturevalue(f"{family}_checkpoint")
    jlm = JTextLM(path, dtype=jnp.float32, int8=int8, int8_kv=int8)
    tlm = TextLM(path, dtype=torch.float32, int8=int8, int8_kv=int8, device="cpu")
    assert type(tlm.config.text_config).__name__ == type(jlm.config.text_config).__name__
    assert tlm.config.text_config.quantize_matmuls == int8
    assert tlm.config.text_config.int8_kv_cache == int8
    gen = dict(max_new_tokens=8, pad_token_id=jlm.tokenizer.pad_token_id, eos_token_id=(0,))
    assert tlm.generate(PROMPTS, GenerationConfig(**gen)) == jlm.generate(PROMPTS, JGenerationConfig(**gen))

    ids, mask = _batch(jlm.tokenizer, PROMPTS)
    gen["eos_token_id"] = ()  # every step runs
    embeds = jlm.module.apply(jlm.variables, jnp.asarray(ids), method=type(jlm.module).embed_and_scatter)
    ref = j_greedy(jlm.module, jlm.variables, embeds, jnp.asarray(mask), JGenerationConfig(**gen),
                   jax.random.PRNGKey(0))
    with torch.no_grad():
        tokens = _greedy_sample_decoder_only(
            tlm.module, tlm.module.embed_and_scatter(torch.from_numpy(ids)),
            torch.from_numpy(mask), GenerationConfig(**gen),
        )
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_text_lm_loads_every_weight(request, family):
    """The HF converters fill the port's state dict from the checkpoint, with
    q/k/v packed into qkv_proj along the output dim."""
    from safetensors.torch import load_file
    import glob
    import os

    path = request.getfixturevalue(f"{family}_checkpoint")
    tlm = TextLM(path, dtype=torch.float32, device="cpu")
    hf = {}
    for f in glob.glob(os.path.join(path, "*.safetensors")):
        hf.update(load_file(f))
    lm = tlm.module.language_model
    prefix = "model.layers.1.self_attn." if family == "llama" else "model.decoder.layers.1.self_attn."
    packed = torch.cat([hf[f"{prefix}{n}_proj.weight"] for n in "qkv"])
    torch.testing.assert_close(lm.layers[1].self_attn.qkv_proj.weight, packed, atol=0, rtol=0)
    emb = "model.embed_tokens.weight" if family == "llama" else "model.decoder.embed_tokens.weight"
    torch.testing.assert_close(lm.embed_tokens.weight, hf[emb], atol=0, rtol=0)


def test_text_lm_unported_modes_raise(request):
    """Speculative decoding is ported (it no longer raises): ``draft=
    "prompt_lookup"`` (greedy and sampling) and ``draft_layers=1`` give the
    JAX TextLM's texts on LLaMA and OPT, the greedy ones the plain greedy
    texts; an unknown draft strategy raises ValueError, as in JAX."""
    for family in ("llama", "opt"):
        path = request.getfixturevalue(f"{family}_checkpoint")
        jlm = JTextLM(path, dtype=jnp.float32)
        tlm = TextLM(path, dtype=torch.float32, device="cpu")
        base = dict(max_new_tokens=8, pad_token_id=0, eos_token_id=(0,))
        plain = tlm.generate(PROMPTS, GenerationConfig(**base))
        for kw in (dict(draft="prompt_lookup", draft_tokens=4), dict(draft_layers=1, draft_tokens=3)):
            ours = tlm.generate(PROMPTS, GenerationConfig(**base), **kw)
            assert ours == jlm.generate(PROMPTS, JGenerationConfig(**base), **kw) == plain, (family, kw)
        # sampling at a point mass: the greedy texts
        point = dict(base, do_sample=True, temperature=1e-7)
        assert tlm.generate(PROMPTS, GenerationConfig(**point), draft="prompt_lookup",
                            generator=torch.Generator().manual_seed(1)) == plain
        with pytest.raises(ValueError, match="prompt_lookup"):
            tlm.generate(PROMPTS, GenerationConfig(**base), draft="tree")


def test_text_lm_rejects_other_families(tmp_path):
    import json

    (tmp_path / "config.json").write_text(json.dumps({"model_type": "t5"}))
    with pytest.raises(ValueError, match="OPT-family"):
        TextLM(str(tmp_path), device="cpu")
