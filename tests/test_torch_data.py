"""Port vs JAX: the port's copies of the jax-free data modules.

``eilev_tpu_torch.data`` keeps its own copies of ``eilev_tpu/data``'s text,
prompts, collate and frame modules (the port imports nothing of
``eilev_tpu``). Each copy must give the JAX package's outputs exactly on the
golden inputs of ``tests/data/``: the narration regex cases, the prompt
layouts on the word-level mock tokenizer (a fresh one a side), the collator
padding rules, and the frame datasets on PNG clips written to ``tmp_path``,
with the same seeded ``random.Random`` a side (in-context sampling,
upsampling, the derangement shuffle).
"""

import csv
import json
import random

import numpy as np
import pytest

from eilev_tpu.data import collate as jcollate
from eilev_tpu.data import frame as jframe
from eilev_tpu.data import prompts as jprompts
from eilev_tpu.data import text as jtext
from eilev_tpu_torch.data import collate as tcollate
from eilev_tpu_torch.data import frame as tframe
from eilev_tpu_torch.data import prompts as tprompts
from eilev_tpu_torch.data import text as ttext

from .data.mock_tokenizer import MockTokenizer

NARRATIONS = [
    "#C C opens a drawer", "#C C opens a drawer.", "  #C C opens a drawer  ", "#c c opens a drawer",
    "#C C picks a knife <|eos|>", "#C C picks a knife<|EOS|>", "#C C stirs #unsure", "#C C stirs #unsure.",
    "#C C stirs the #unsure in the pot", "#C C waves!", "", "#unsure",
]


def _same(a, b):
    """Equal nested outputs: dicts, lists and numpy arrays (dtype included)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_text_matches_jax():
    for raw in NARRATIONS:
        assert ttext.clean_narration_text(raw) == jtext.clean_narration_text(raw)
    for ts in ("00:00:00.00", "00:01:30.50", "10:20:30.25"):
        assert ttext.parse_timestamp(ts) == jtext.parse_timestamp(ts)
    for items, n in (([1, 2, 3, 4, 5], 2), ([], 3), ([1], 5)):
        assert list(ttext.generate_chunks(items, n)) == list(jtext.generate_chunks(items, n))


PROMPT_CASES = {
    "v1_decoder_only": ("v1", dict(prompt="Question: what? Answer:", text="opens drawer", decoder_only_lm=True)),
    "v1_seq2seq": ("v1", dict(prompt="prompt words", text="target text", decoder_only_lm=False)),
    "interleaved_decoder_only": ("v2", dict(prompts=[("What is happening?", 2), ("And now?", 1)],
                                            text="a narration", num_query_tokens=3, decoder_only_lm=True)),
    "interleaved_no_text": ("v2", dict(prompts=[("Q: what? A:", 1)], text=None, num_query_tokens=2,
                                       decoder_only_lm=True)),
    "interleaved_seq2seq": ("v2", dict(prompts=[("first", 1), ("second one", 2)], text="the target",
                                       num_query_tokens=3, decoder_only_lm=False)),
}


@pytest.mark.parametrize("case", sorted(PROMPT_CASES))
def test_prompts_match_jax(case):
    kind, kw = PROMPT_CASES[case]
    opt_style = kw["decoder_only_lm"]
    name = "generate_input_ids_and_labels" + ("" if kind == "v1" else "_from_interleaved")
    ref_tok, our_tok = MockTokenizer(opt_style), MockTokenizer(opt_style)
    ref = getattr(jprompts, name)(ref_tok, **kw)
    ours = getattr(tprompts, name)(our_tok, **kw)
    _same(ours, ref)
    assert our_tok.vocab == ref_tok.vocab
    assert tprompts.IGNORE_INDEX == jprompts.IGNORE_INDEX


def _feat(ids, labels=None, vim=None, videos=0):
    f = {"input_ids": np.asarray(ids)}
    if labels is not None:
        f["labels"] = np.asarray(labels)
    if vim is not None:
        f["video_input_mask"] = np.asarray(vim)
    if videos:
        f["pixel_values"] = np.arange(videos * 3 * 2 * 16, dtype=np.float32).reshape(videos, 3, 2, 4, 4)
    return f


COLLATE_CASES = {
    "v1_stacks_pixels": ("DataCollatorForVideoSeq2Seq", dict(pad_token_id=1),
                         [dict(ids=[5, 6, 7], labels=[-100, 6, 7]), dict(ids=[5, 6], labels=[-100, 6])]),
    "interleaved_right": ("DataCollatorForInterleavedVideoSeq2Seq", dict(pad_token_id=1, padding_side="right"),
                          [dict(ids=[5, 6, 7, 8], vim=[0, 1, 1, 0], videos=2), dict(ids=[5, 6], vim=[1, 0], videos=1)]),
    "interleaved_left": ("DataCollatorForInterleavedVideoSeq2Seq", dict(pad_token_id=1, padding_side="left"),
                         [dict(ids=[5, 6, 7, 8], vim=[0, 1, 1, 0]), dict(ids=[5, 6], vim=[1, 0])]),
    "pad_to_multiple_of": ("DataCollatorForInterleavedVideoSeq2Seq", dict(pad_token_id=1, pad_to_multiple_of=8),
                           [dict(ids=[5, 6, 7], vim=[1, 1, 0], labels=[-100, -100, 7])]),
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_collate_matches_jax(case):
    cls, kw, feats = COLLATE_CASES[case]
    batch = [_feat(**f) for f in feats]
    if cls == "DataCollatorForVideoSeq2Seq":  # v1: one (C, T, H, W) video a sample
        batch = [dict(f, pixel_values=np.ones((3, 2, 4, 4), np.float32)) for f in batch]
    _same(getattr(tcollate, cls)(**kw)(batch), getattr(jcollate, cls)(**kw)(batch))
    for side in ("left", "right"):
        arr = np.asarray([3, 4])
        _same(tcollate._pad_1d(arr, 5, 9, side), jcollate._pad_1d(arr, 5, 9, side))
    _same(tcollate._pad_1d(np.arange(4), 2, 0, "left"), jcollate._pad_1d(np.arange(4), 2, 0, "left"))


ACTIONS = [("take", "knife"), ("take", "spoon"), ("cut", "knife"), ("cut", "onion"),
           ("wash", "knife"), ("take", "knife"), ("[other]", ""), ("stir", "pot")]


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """tests/data/test_frame.py's clips: 8 clips x 2 frames of 4x4 PNG, pixel
    value i * 10 + t, with its verb/noun structure."""
    import imageio.v3 as iio

    root = tmp_path_factory.mktemp("frames")
    rows = []
    for i, (verb, noun) in enumerate(ACTIONS):
        fp = f"vid{i}|0"
        (root / fp).mkdir()
        for t in range(2):
            iio.imwrite(root / fp / f"{fp}|{t}.png", np.full((4, 4, 3), i * 10 + t, np.uint8), extension=".png")
        rows.append({"frame_path": fp, "video_uid": f"vid{i}", "clip_index": "0",
                     "narration_timestamp_sec": "4.0", "narration_text": f"#C C does action {i}",
                     "structured_verb": verb, "structured_noun": noun})
    with open(root / "narrated_actions.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    map_file = root / "map.jsonl"
    with open(map_file, "w") as f:
        f.write(json.dumps({"context": ["vid1|0", "vid2|0", "vid3|0", "vid4|0"], "query": "vid0|0"}) + "\n")
        f.write(json.dumps({"context": ["vid3|0"], "query": "vid7|0"}) + "\n")
    return root


def test_frame_dataset_matches_jax(frames_dir):
    for kw in ({}, {"return_frames": False}, {"data_filter": lambda r: r["structured_verb"] == "take"}):
        ours, ref = tframe.FrameDataset(str(frames_dir), **kw), jframe.FrameDataset(str(frames_dir), **kw)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            _same(ours[i], ref[i])
        _same(ours[ref.data[0]["frame_path"]], ref[ref.data[0]["frame_path"]])
    video = tframe.load_frame_video(frames_dir / "vid3|0")
    assert video.shape == (3, 2, 4, 4) and video[0, 1, 0, 0] == 31
    _same(video, jframe.load_frame_video(frames_dir / "vid3|0"))


INTERLEAVED_CASES = {
    "buckets": dict(num_in_context_examples_per_sample=4, seed=0),
    "seeded_three": dict(num_in_context_examples_per_sample=3, seed=7),
    "random_examples": dict(num_in_context_examples_per_sample=4, random_in_context_examples=True, seed=1),
    "upsample_22": dict(num_in_context_examples_per_sample=2, target_dataset_len=22, seed=2),
    "upsample_16": dict(num_in_context_examples_per_sample=2, target_dataset_len=16, seed=2),
    "separate_examples": dict(num_in_context_examples_per_sample=4, separate=True, seed=3),
    "with_frames": dict(num_in_context_examples_per_sample=2, return_frames=True, seed=4),
}


@pytest.mark.parametrize("case", sorted(INTERLEAVED_CASES))
def test_interleaved_dataset_matches_jax(frames_dir, case):
    """Bucketed and random in-context sampling and ``_upsample_to`` (the
    JAX package's rule, which departs from the original EILeV's) draw the
    same examples in the same order from the same seeded rng."""
    kw = dict(INTERLEAVED_CASES[case])
    seed = kw.pop("seed")
    if kw.pop("separate", False):
        kw["in_context_example_frames_dir"] = str(frames_dir)
    kw.setdefault("return_frames", False)
    ours = tframe.FrameInterleavedDataset(str(frames_dir), rng=random.Random(seed), **kw)
    ref = jframe.FrameInterleavedDataset(str(frames_dir), rng=random.Random(seed), **kw)
    assert len(ours) == len(ref)
    _same(ours._dataset.data, ref._dataset.data)
    for i in range(len(ref)):
        _same(ours[i], ref[i])


@pytest.mark.parametrize("shuffle", [False, True])
def test_presampled_dataset_matches_jax(frames_dir, shuffle):
    kw = dict(in_context_query_map_file_path=str(frames_dir / "map.jsonl"),
              in_context_example_frames_dir=str(frames_dir), shuffle_in_context_example_frames=shuffle)
    ours = tframe.FrameInterleavedPresampledDataset(str(frames_dir), rng=random.Random(5), **kw)
    ref = jframe.FrameInterleavedPresampledDataset(str(frames_dir), rng=random.Random(5), **kw)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        _same(ours[i], ref[i])


@pytest.mark.parametrize("fmt", ["png", "raw"])
def test_save_frame_video_round_trips_as_in_jax(tmp_path, fmt):
    clip = np.random.default_rng(3).integers(0, 256, (3, 4, 6, 5), dtype=np.uint8)
    tframe.save_frame_video(tmp_path / "ours", "vidX|2", clip, fmt=fmt)
    jframe.save_frame_video(tmp_path / "ref", "vidX|2", clip, fmt=fmt)
    ours = tframe.load_frame_video(tmp_path / "ours" / "vidX|2")
    _same(ours, clip)
    _same(ours, jframe.load_frame_video(tmp_path / "ref" / "vidX|2"))
    assert sorted(p.name for p in (tmp_path / "ours" / "vidX|2").iterdir()) == sorted(
        p.name for p in (tmp_path / "ref" / "vidX|2").iterdir())
