"""Port vs JAX: the Q-Former (models/qformer.py) at tiny_config, fp32, atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.models.qformer import QFormerModel as JQFormer
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models.qformer import QFormerModel

from ._torch_port import load_port, random_params, to_np


@pytest.mark.parametrize("cross_every,masked", [(1, False), (2, False), (2, True)])
def test_qformer_matches_flax(cross_every, masked):
    qcfg = configs.replace(
        configs.tiny_config(layers=3).qformer_config,
        cross_attention_frequency=cross_every,
        encoder_hidden_size=24,
    )
    rng = np.random.default_rng(cross_every)
    b, nq, kv = 2, 4, 10
    query = rng.normal(size=(b, nq, qcfg.hidden_size)).astype(np.float32)
    enc = rng.normal(size=(b, kv, 24)).astype(np.float32)
    enc_mask = np.ones((b, kv), np.int32)
    if masked:
        enc_mask[1, 6:] = 0
    jmodel = JQFormer(qcfg)
    params = random_params(jmodel, 2, jnp.asarray(query), jnp.asarray(enc))
    ref = jmodel.apply(
        {"params": params}, jnp.asarray(query), jnp.asarray(enc),
        jnp.asarray(enc_mask) if masked else None,
    )
    tcfg = tconfigs.replace(
        tconfigs.tiny_config(layers=3).qformer_config,
        cross_attention_frequency=cross_every,
        encoder_hidden_size=24,
    )
    ours = load_port(QFormerModel(tcfg), params)
    with torch.no_grad():
        out = ours(
            torch.from_numpy(query), torch.from_numpy(enc),
            torch.from_numpy(enc_mask) if masked else None,
        )
    assert tuple(out.shape) == (b, nq, qcfg.hidden_size)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=1e-4, rtol=0)
