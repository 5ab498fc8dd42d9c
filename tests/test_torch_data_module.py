"""The port's train_batch_iterator (eilev_tpu_torch/training/data_module.py)
against eilev_tpu.training.data_module, mirroring
tests/training/test_data_module.py: the same datasets and a fresh
MockTokenizer a side (it numbers words in call order). Token ids, labels and
masks are identical to JAX's; pixels without augmentation within 1e-5; with
augmentation (its own draws) the shapes, finiteness and masking hold; the
thread-pool loader is bit-identical to serial iteration."""

import random

import numpy as np
import pytest
import torch

from eilev_tpu.training.data_module import train_batch_iterator as jax_iterator
from eilev_tpu_torch.training.data_module import PROMPTS, V1_PROMPT, train_batch_iterator
from tests.data.mock_tokenizer import MockTokenizer

KW = dict(num_query_tokens=3, decoder_only_lm=True, num_frames=2, image_size=16, seed=0, epochs=1)


class _DS:
    """Interleaved-style dataset: {'items': [example, query]} with tiny videos."""

    def __init__(self, n=6, videos_per=2):
        self.n = n
        self.videos_per = videos_per
        rng = np.random.default_rng(0)
        self.videos = rng.integers(0, 256, (n, 3, 4, 16, 16)).astype(np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        items = [
            {"narration_text": f"#C C does thing {j}", "video": self.videos[(i + j) % self.n]}
            for j in range(self.videos_per)
        ]
        return {"items": items}


class _V1DS(_DS):
    def __getitem__(self, i):
        return {"narration_text": f"#C C acts {i}", "video": self.videos[i]}


def _pair(ds_factory, **kw):
    """The JAX iterator's batches and the port's (device="cpu"), each over a
    fresh dataset and tokenizer."""
    theirs = list(jax_iterator(ds_factory(), MockTokenizer(), **kw))
    ours = list(train_batch_iterator(ds_factory(), MockTokenizer(), device="cpu", **kw))
    return theirs, ours


def _same_tokens(theirs, ours):
    assert len(theirs) == len(ours) > 0
    for a, b in zip(theirs, ours):
        assert sorted(a) == sorted(b)
        for key in a:
            if key == "pixel_values":
                continue
            assert b[key].device.type == "cpu"
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]), err_msg=key)


@pytest.mark.parametrize("augment", [False, True])
def test_static_shapes_and_masking_match_jax(augment):
    kw = dict(KW, accum_steps=2, micro_batch_size=1, max_length=48)
    theirs, ours = _pair(_DS, augment=False, **kw)
    if augment:
        ours = list(train_batch_iterator(_DS(), MockTokenizer(), device="cpu", augment=True, **kw))
    _same_tokens(theirs, ours)
    assert len(ours) == 3  # 6 samples / (2 accum * 1 micro)
    for a, b in zip(theirs, ours):
        assert b["input_ids"].shape == (2, 1, 48)
        assert b["video_input_mask"].shape == (2, 1, 48)
        assert b["pixel_values"].shape == (2, 2, 3, 2, 16, 16)
        assert b["pixel_values"].dtype == torch.float32 and torch.isfinite(b["pixel_values"]).all()
        if not augment:
            np.testing.assert_allclose(b["pixel_values"].numpy(), np.asarray(a["pixel_values"]), atol=1e-5)
        pad = b["attention_mask"] == 0
        assert (b["labels"][pad] == -100).all()
        vim = b["video_input_mask"].bool()
        assert int(vim.sum()) == 2 * 1 * 2 * 3
        assert (b["labels"][vim] == -100).all() and (b["labels"] != -100).any()


def test_augmented_batches_are_seeded():
    kw = dict(KW, accum_steps=1, micro_batch_size=2, max_length=48, augment=True)
    a = list(train_batch_iterator(_DS(), MockTokenizer(), device="cpu", **kw))
    b = list(train_batch_iterator(_DS(), MockTokenizer(), device="cpu", **kw))
    c = list(train_batch_iterator(_DS(), MockTokenizer(), device="cpu", **dict(kw, seed=1)))
    assert all(torch.equal(x["pixel_values"], y["pixel_values"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["pixel_values"], c[0]["pixel_values"])


def test_v1_mode_matches_jax():
    kw = dict(KW, accum_steps=1, micro_batch_size=2, max_length=24, augment=False, interleaved=False)
    theirs, ours = _pair(_V1DS, **kw)
    _same_tokens(theirs, ours)
    b = ours[0]
    assert b["input_ids"].shape == (1, 2, 24)
    assert b["pixel_values"].shape == (1, 2, 3, 2, 16, 16)
    assert "video_input_mask" not in b
    np.testing.assert_allclose(b["pixel_values"].numpy(), np.asarray(theirs[0]["pixel_values"]), atol=1e-5)


def test_multihost_striding_disjoint_and_complete():
    class _Rec(_DS):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __getitem__(self, i):
            self.seen.append(i)
            return super().__getitem__(i)

    def indices_seen(proc, nproc):
        ds = _Rec()
        it = train_batch_iterator(ds, MockTokenizer(), accum_steps=1, micro_batch_size=1, max_length=48,
                                  augment=False, process_index=proc, process_count=nproc, device="cpu", **KW)
        return ds.seen, sum(1 for _ in it)

    full, n_full = indices_seen(0, 1)
    h0, n0 = indices_seen(0, 2)
    h1, n1 = indices_seen(1, 2)
    assert n_full == 6 and n0 == 3 and n1 == 3
    assert h0 == full[0::2] and h1 == full[1::2]
    assert sorted(h0 + h1) == sorted(full)


def test_truncating_a_video_slot_raises():
    with pytest.raises(ValueError, match="max_length"):
        next(train_batch_iterator(_DS(), MockTokenizer(), accum_steps=1, micro_batch_size=1, max_length=6,
                                  augment=False, device="cpu", **KW))


def _make_frames_dir(root):
    """Tiny PNG frames tree (the extract_frames contract), as the JAX test builds it."""
    import csv

    import imageio.v3 as iio

    rows = []
    actions = [("take", "knife"), ("take", "spoon"), ("cut", "knife"),
               ("cut", "onion"), ("wash", "knife"), ("stir", "pot")]
    for i, (verb, noun) in enumerate(actions):
        fp = f"vid{i}|0"
        d = root / fp
        d.mkdir(parents=True)
        for t in range(2):
            iio.imwrite(d / f"{fp}|{t}.png", np.full((8, 8, 3), i * 10 + t, np.uint8), extension=".png")
        rows.append({"frame_path": fp, "video_uid": f"vid{i}", "clip_index": "0",
                     "narration_timestamp_sec": "4.0", "narration_text": f"#C C does action {i}",
                     "structured_verb": verb, "structured_noun": noun})
    with open(root / "narrated_actions.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_num_workers_batches_bit_identical_and_match_jax(tmp_path):
    from eilev_tpu.data.frame import FrameInterleavedDataset as JFrames
    from eilev_tpu_torch.data.frame import FrameInterleavedDataset

    _make_frames_dir(tmp_path / "frames")
    kw = dict(num_query_tokens=2, decoder_only_lm=True, accum_steps=1, micro_batch_size=2, max_length=64,
              num_frames=2, image_size=8, augment=False, seed=3, epochs=2)

    tok = MockTokenizer()  # shared, as in the JAX test: it numbers words in call order

    def ours(workers):
        ds = FrameInterleavedDataset(str(tmp_path / "frames"), num_in_context_examples_per_sample=2,
                                     rng=random.Random(7))
        return list(train_batch_iterator(ds, tok, num_workers=workers, device="cpu", **kw))

    serial, parallel = ours(0), ours(3)
    assert len(serial) == len(parallel) > 1
    for a, b in zip(serial, parallel):
        assert sorted(a) == sorted(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key
    jds = JFrames(str(tmp_path / "frames"), num_in_context_examples_per_sample=2, rng=random.Random(7))
    theirs = list(jax_iterator(jds, MockTokenizer(), **kw))
    _same_tokens(theirs, serial)
    for a, b in zip(theirs, serial):
        np.testing.assert_allclose(b["pixel_values"].numpy(), np.asarray(a["pixel_values"]), atol=1e-5)


def test_num_workers_requires_plannable_dataset():
    with pytest.raises(ValueError, match="plan"):
        next(train_batch_iterator(_DS(), MockTokenizer(), num_query_tokens=2, decoder_only_lm=True,
                                  accum_steps=1, micro_batch_size=1, max_length=32, num_frames=2,
                                  image_size=8, augment=False, num_workers=2, device="cpu"))


def test_prompt_pools_are_the_reference_ones():
    from eilev_tpu.training import data_module as jdm

    assert PROMPTS == jdm.PROMPTS and V1_PROMPT == jdm.V1_PROMPT
