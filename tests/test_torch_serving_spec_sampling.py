"""Port vs JAX: per-slot prompt-lookup speculative serving, decoder-only,
sampling (split from ``tests/test_torch_serving_spec.py``, whose world,
config and engine helper it shares, so that ``--dist loadfile`` runs the
greedy and the sampling halves in two workers).

Sampling draws from a ``torch.Generator``, so it is held by law: a
point-mass temperature gives the rows of JAX's isolated greedy ``generate``
(also under pressure), every row is pad after its first eos, and the
per-position marginals equal the port's plain sampling loop's within a
stated chi-square bound.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats as sstats

from eilev_tpu_torch.generation import GenerationConfig, generate

from ._torch_serving import assert_rows, reference_rows
from .test_torch_serving_spec import GEN, spec, world  # noqa: F401  (the module-scoped world fixture)


POINT_MASS = dict(GEN, do_sample=True, temperature=1e-7)


@pytest.mark.parametrize("seed", [0, 7])
def test_spec_sampling_point_mass_equals_greedy(world, seed):  # noqa: F811
    requests = [world.make_request(s, extra_text=s % 3) for s in range(4)]
    ref = reference_rows(world, requests, **GEN)
    eng = spec(world, POINT_MASS, generator=torch.Generator().manual_seed(seed))
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    assert eng.stats["spec_passes"] > 0


def test_spec_sampling_point_mass_under_pressure(world):  # noqa: F811
    """Through compaction, the plain-decode fallback (which redraws the
    pending tokens) and eviction."""
    requests = [world.make_request(s) for s in range(5)]
    ref = reference_rows(world, requests, **GEN)
    eng = spec(world, POINT_MASS, max_len=48)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    assert eng.stats["compactions"] + eng.stats["resets"] + eng.stats["spec_fallback_chunks"] > 0


def test_spec_sampling_eos_pad_contract(world):  # noqa: F811
    """Wherever an eos is sampled, the positions after it are pad."""
    gen = dict(max_new_tokens=8, pad_token_id=1, eos_token_id=(5, 9), do_sample=True, temperature=3.0)
    req = world.make_request(3)
    eng = spec(world, gen, max_slots=8, max_len=64, generator=torch.Generator().manual_seed(0))
    done = eng.run([dataclasses.replace(req) for _ in range(24)])
    saw_eos = False
    for c in done.values():
        eos_pos = np.where((c.tokens == 5) | (c.tokens == 9))[0]
        if eos_pos.size:
            saw_eos = True
            assert np.all(c.tokens[eos_pos[0] + 1 :] == 1), c.tokens
    assert saw_eos


# the marginals' bar: each (row, position) two-sample chi-square test of the
# engine's tokens against the plain sampling loop's must not reject at this
# level (20 tests; deterministic seeds, so a pass is a fixed result)
MARGINAL_P = 1e-3
MARGINAL_N = 240


def test_spec_sampling_marginals_match_plain_sampling(world):  # noqa: F811
    """Per-position marginals of the speculative-sampling engine against the
    port's plain sampling loop (``generate`` with a generator), for two
    requests of echo-rich prompts (so drafts are accepted and rejected):
    MARGINAL_N copies of each request through one engine of 16 slots (each
    slot draws on its own), and one batch of MARGINAL_N copies through the
    plain loop. top_k 4 bounds the support."""
    gen = dict(max_new_tokens=4, pad_token_id=1, eos_token_id=(), do_sample=True, temperature=1.3, top_k=4)
    base = [world.make_request(0), world.make_request(1)]
    reqs = []
    for r in base:
        tail = np.tile(r.input_ids[-4:], 2)
        reqs.append(dataclasses.replace(r, input_ids=np.concatenate([r.input_ids, tail]),
                                        video_input_mask=np.concatenate([r.video_input_mask, np.zeros(8, np.int64)])))
    eng = spec(world, gen, max_slots=16, max_len=64, generator=torch.Generator().manual_seed(1))
    done = eng.run([dataclasses.replace(r) for r in reqs for _ in range(MARGINAL_N)])
    assert eng.stats["spec_tokens"] > eng.stats["spec_rows"], eng.stats
    worst = 1.0
    for i, r in enumerate(reqs):
        engine_rows = np.stack([done[i * MARGINAL_N + j].tokens for j in range(MARGINAL_N)])
        plain = generate(
            world.model, input_ids=torch.from_numpy(np.tile(r.input_ids, (MARGINAL_N, 1))),
            pixel_values=torch.from_numpy(np.tile(r.pixel_values, (MARGINAL_N, 1, 1, 1, 1))),
            video_input_mask=torch.from_numpy(np.tile(r.video_input_mask, (MARGINAL_N, 1))),
            generation_config=GenerationConfig(**gen), generator=torch.Generator().manual_seed(2 + i),
        ).numpy()
        for pos in range(gen["max_new_tokens"]):
            support = np.union1d(engine_rows[:, pos], plain[:, pos])
            if len(support) < 2:
                continue
            table = np.stack([[np.sum(x[:, pos] == t) for t in support] for x in (engine_rows, plain)])
            p = sstats.chi2_contingency(table)[1]
            worst = min(worst, p)
            assert p > MARGINAL_P, (i, pos, table)
    print(f"smallest chi-square p-value over the marginals: {worst}")
