"""Port vs JAX: the data-preparation, sentence and analysis tools
(``eilev_tpu_torch/cli/{ego4d,epic_kitchens}/``, ``cli/explore_data``,
``cli/select_qualitative_examples``, ``cli/plot_results``), each against the
JAX package's script run in this process (``runpy``) on the same arguments:

- the two extractors: the clips the JAX package's prebuilt decoder reads
  from y4m videos go through the port's ``extract()`` on the CPU, in both
  frame formats: the CSV equal to the JAX script's, every frame within one
  uint8 level (the bicubic resize is fp32 in both; a value near .5 may round
  either way); where the port's own decoder builds, its ``main`` end to end
  too;
- the split (byte for byte) and the annotation backfill (byte for byte);
- the two sentence tools on tiny LLaMA and OPT ``TextLM`` checkpoints, fp32
  in both packages: equal CSVs;
- explore (the report and the plot files), select (the kept rows) and plot
  (each figure's PNG, byte for byte; t-SNE's draws are unseeded in both, so
  its figure is held to exist) on ``tests/integration/test_tooling_clis.py``'s
  worlds.
"""

import csv
import functools
import json
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eilev_tpu.generation.text_lm as jtext_lm
import eilev_tpu_torch.generation.text_lm as ttext_lm
from eilev_tpu.data.video_datasets import EpicKitchensDataset as JEpicKitchensDataset
from eilev_tpu.data.video_datasets import Ego4dFHOMainDataset as JEgo4dFHOMainDataset
from eilev_tpu_torch.cli import explore_data, plot_results, select_qualitative_examples
from eilev_tpu_torch.cli.ego4d import add_structured_verb_noun, extract_frames, generate_std_sent, split_train_val_test
from eilev_tpu_torch.cli.epic_kitchens import epic_kitchens_extract_frames, transform_to_full_sent
from eilev_tpu_torch.data.frame import load_frame_video
from eilev_tpu_torch.native import decoder_available

from .util_tokenizer import build_tiny_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_script(path: str, argv: list[str]) -> None:
    """The JAX package's script at ``path`` (from the repo root), in this process."""
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        runpy.run_path(os.path.join(REPO, path), run_name="__main__")
    finally:
        sys.argv = old


def write_noise_y4m(path: str, nframes: int, w: int, h: int, fps: int, seed: int) -> None:
    """A y4m video of seeded random 4:2:0 frames (every pixel its own value,
    so the resize has detail to round)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for _ in range(nframes):
            f.write(b"FRAME\n")
            for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
                f.write(rng.integers(16, 236, shape, dtype=np.uint8).tobytes())


def _action(j: int, rejected: bool = False) -> dict:
    return {
        "is_rejected": rejected, "is_valid_action": not rejected, "narration_timestamp_sec": 2.0 + 3.0 * j,
        "narration_text": f"#C C does {j} ", "structured_verb": ["take", "cut_(slice)"][j % 2],
        "frames": [{"frame_type": "pnr_frame", "boxes": [
            {"object_type": "object_of_change", "structured_noun": ["knife", "onion_(bulb)"][j % 2]}]}],
    }


def write_fho_world(root, n_videos: int = 2, n_actions: int = 3) -> dict:
    """y4m videos named ``<uid>.mp4`` (12 s at 10 fps, 40 x 24), an fho_main
    whose videos hold ``n_actions`` actions and one rejected action each, and a
    split naming every video. Returns the paths."""
    videos = root / "videos"
    videos.mkdir(parents=True)
    fho = {"videos": []}
    for i in range(n_videos):
        uid = f"vid{i}"
        write_noise_y4m(str(videos / f"{uid}.mp4"), nframes=120, w=40, h=24, fps=10, seed=i)
        actions = [_action(j) for j in range(n_actions)] + [_action(n_actions, rejected=True)]
        fho["videos"].append({"video_uid": uid, "annotated_intervals": [{"narrated_actions": actions}]})
    (root / "fho_main.json").write_text(json.dumps(fho))
    (root / "split.json").write_text(json.dumps({"split": "all", "videos": {f"vid{i}": n_actions
                                                                             for i in range(n_videos)}}))
    return {"fho_main": str(root / "fho_main.json"), "split": str(root / "split.json"), "videos": str(videos)}


def _rows(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def assert_same_extraction(ours: str, ref: str) -> float:
    """The two frame trees' CSVs equal and every frame within one uint8
    level; returns the share of pixels that differ."""
    rows = _rows(os.path.join(ours, "narrated_actions.csv"))
    assert rows == _rows(os.path.join(ref, "narrated_actions.csv")) and rows
    differ, total = 0, 0
    for row in rows:
        a, b = (load_frame_video(_path(d, row["frame_path"])).astype(np.int16) for d in (ours, ref))
        assert a.shape == b.shape
        assert int(np.abs(a - b).max()) <= 1, row["frame_path"]
        differ, total = differ + int((a != b).sum()), total + a.size
    return differ / total


def _path(root: str, frame_path: str):
    from pathlib import Path

    return Path(root) / frame_path


@pytest.mark.parametrize("fmt", ["png", "raw"])
def test_ego4d_extract_matches_jax(tmp_path, fmt):
    world = write_fho_world(tmp_path)
    common = ["--num_subsample_frames", "4", "--target_size", "16", "--format", fmt, "--num_workers", "2"]
    run_jax_script("scripts/ego4d/extract_frames.py",
                   ["--fho_main_path", world["fho_main"], "--split_path", world["split"],
                    "--video_dir_path", world["videos"], "--frames_dir", str(tmp_path / "ref"), *common])
    items = JEgo4dFHOMainDataset(world["fho_main"], world["split"], world["videos"], num_frames=4)
    args = extract_frames.parse_args(["--fho_main_path", world["fho_main"], "--split_path", world["split"],
                                      "--video_dir_path", world["videos"], "--frames_dir", str(tmp_path / "ours"),
                                      *common, "--device", "cpu"])
    stats = extract_frames.extract(items, args, torch.device("cpu"))
    assert stats["clips"] == 6
    assert len(_rows(tmp_path / "ours" / "narrated_actions.csv")) == 6  # the rejected actions dropped
    share = assert_same_extraction(str(tmp_path / "ours"), str(tmp_path / "ref"))
    print(f"share of pixels one level apart: {share}")
    # the clip count cap and --csv_only, as in the JAX script
    capped = extract_frames.parse_args(["--fho_main_path", "-", "--split_path", "-", "--video_dir_path", "-",
                                        "--frames_dir", str(tmp_path / "capped"), "--num_subsample_frames", "4",
                                        "--max_num_narrated_actions", "2", "--csv_only"])
    assert extract_frames.extract(items, capped, torch.device("cpu"))["clips"] == 2
    assert sorted(os.listdir(tmp_path / "capped")) == ["narrated_actions.csv"]
    if decoder_available():  # the port's own decoder, end to end
        extract_frames.main(["--fho_main_path", world["fho_main"], "--split_path", world["split"],
                             "--video_dir_path", world["videos"], "--frames_dir", str(tmp_path / "main"),
                             *common, "--device", "cpu"])
        assert_same_extraction(str(tmp_path / "main"), str(tmp_path / "ref"))


def test_epic_kitchens_extract_matches_jax(tmp_path):
    ek55, ek100 = tmp_path / "ek55", tmp_path / "ek100"
    (ek55 / "videos/train/P01").mkdir(parents=True)
    (ek100 / "P01/videos").mkdir(parents=True)
    write_noise_y4m(str(ek55 / "videos/train/P01/P01_01.MP4"), nframes=120, w=32, h=16, fps=10, seed=0)
    write_noise_y4m(str(ek100 / "P01/videos/P01_101.MP4"), nframes=80, w=32, h=16, fps=10, seed=1)
    ann = tmp_path / "ann.csv"
    with open(ann, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "narration", "full_sent_narration", "verb", "noun", "narration_timestamp",
                    "start_timestamp", "stop_timestamp"])
        w.writerow(["P01_01", "open door", "The camera wearer opens the door.", "open", "door", "00:00:05.00",
                    "00:00:04.00", "00:00:06.00"])
        w.writerow(["P01_01", "wash cup", " The camera wearer washes the cup. ", "wash", "cup", "",
                    "00:00:07.00", "00:00:09.00"])
        w.writerow(["P01_101", "take plate", "The camera wearer takes the plate.", "take", "plate",
                    "00:00:03.00", "00:00:02.00", "00:00:04.00"])
    argv = ["--annotation_path", str(ann), "--epic_kitchens_55_video_dir_path", str(ek55),
            "--epic_kitchens_100_video_dir_path", str(ek100), "--num_subsample_frames", "4", "--target_size", "16"]
    run_jax_script("scripts/epic_kitchens/epic_kitchens_extract_frames.py",
                   argv + ["--frames_dir", str(tmp_path / "ref")])
    items = JEpicKitchensDataset(str(ann), str(ek55), str(ek100), num_frames=4)
    args = epic_kitchens_extract_frames.parse_args(argv + ["--frames_dir", str(tmp_path / "ours")])
    assert epic_kitchens_extract_frames.extract(items, args, torch.device("cpu"),
                                                row=epic_kitchens_extract_frames.epic_kitchens_row)["clips"] == 3
    assert_same_extraction(str(tmp_path / "ours"), str(tmp_path / "ref"))
    assert _rows(tmp_path / "ours" / "narrated_actions.csv")[1]["narration_text"] == \
        "The camera wearer washes the cup."
    if decoder_available():
        epic_kitchens_extract_frames.main(argv + ["--frames_dir", str(tmp_path / "main"), "--device", "cpu"])
        assert_same_extraction(str(tmp_path / "main"), str(tmp_path / "ref"))


@pytest.fixture()
def fho_world(tmp_path):
    """``tests/integration/test_tooling_clis.py``'s world: 6 videos of 1-6
    accepted actions."""
    videos = tmp_path / "videos"
    videos.mkdir()
    fho = {"videos": []}
    for i in range(6):
        uid = f"vid{i}"
        (videos / f"{uid}.mp4").write_bytes(b"x")  # existence is all the split needs
        actions = [{"is_rejected": False, "is_valid_action": True, "narration_text": f"#C C does {j}",
                    "structured_verb": ["take", "cut"][j % 2],
                    "frames": [{"frame_type": "pnr_frame",
                                "boxes": [{"object_type": "object_of_change", "structured_noun": "knife"}]}]}
                   for j in range(i + 1)]
        fho["videos"].append({"video_uid": uid, "annotated_intervals": [{"narrated_actions": actions}]})
    (tmp_path / "fho_main.json").write_text(json.dumps(fho))
    return tmp_path


@pytest.mark.parametrize("seed", [42, 7])
def test_split_matches_jax_byte_for_byte(fho_world, seed):
    argv = [str(fho_world / "fho_main.json"), None, str(fho_world / "videos"), "--seed", str(seed)]
    ours, ref = fho_world / "ours", fho_world / "ref"
    splits = split_train_val_test.main([str(ours) if a is None else a for a in argv])
    run_jax_script("scripts/ego4d/split_train_val_test.py", [str(ref) if a is None else a for a in argv])
    for name in ("train", "val", "test"):
        assert (ours / f"fho_main_{name}.json").read_bytes() == (ref / f"fho_main_{name}.json").read_bytes()
    assert sum(sum(v.values()) for v in splits.values()) == 21


def test_add_structured_verb_noun_matches_jax(fho_world, tmp_path):
    src = tmp_path / "na.csv"
    with open(src, "w", newline="") as f:
        w = csv.DictWriter(f, ["frame_path", "video_uid", "clip_index", "narration_timestamp_sec",
                               "narration_text"])
        w.writeheader()
        for uid, clip in (("vid2", 1), ("vid5", 4), ("vid0", 0)):
            w.writerow(dict(frame_path=f"{uid}|{clip}", video_uid=uid, clip_index=str(clip),
                            narration_timestamp_sec="4.0", narration_text=f"#C C does {clip}"))
    argv = [str(fho_world / "fho_main.json"), str(src)]
    add_structured_verb_noun.main(argv + [str(tmp_path / "ours.csv")])
    run_jax_script("scripts/ego4d/add_structured_verb_noun.py", argv + [str(tmp_path / "ref.csv")])
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    assert [r["structured_verb"] for r in _rows(tmp_path / "ours.csv")] == ["cut", "take", "take"]


@pytest.fixture(scope="module")
def lm_checkpoints(tmp_path_factory):
    """Tiny LLaMA (GQA) and OPT ``TextLM`` checkpoints with 512 positions:
    the few-shot prompts and their new tokens."""
    from transformers import LlamaConfig, LlamaForCausalLM, OPTConfig, OPTForCausalLM

    paths = {}
    for family, cls, cfg in (
        ("llama", LlamaForCausalLM, LlamaConfig(vocab_size=384, hidden_size=32, num_hidden_layers=2,
                                                num_attention_heads=4, num_key_value_heads=2,
                                                intermediate_size=64, max_position_embeddings=512,
                                                attn_implementation="eager")),
        ("opt", OPTForCausalLM, OPTConfig(vocab_size=384, hidden_size=16, num_hidden_layers=2,
                                          num_attention_heads=2, ffn_dim=32, max_position_embeddings=512,
                                          word_embed_proj_dim=16, dropout=0.0, attention_dropout=0.0)),
    ):
        d = str(tmp_path_factory.mktemp(f"{family}_ckpt"))
        torch.manual_seed(0)
        cls(cfg).eval().save_pretrained(d, safe_serialization=True)
        build_tiny_tokenizer(d, vocab_size=384)
        paths[family] = d
    return paths


@pytest.fixture()
def fp32_text_lms(monkeypatch):
    """fp32 in both packages (the scripts' TextLM computes in bf16 by default)."""
    monkeypatch.setattr(jtext_lm, "TextLM", functools.partial(jtext_lm.TextLM, dtype=jnp.float32))
    monkeypatch.setattr(ttext_lm, "TextLM", functools.partial(ttext_lm.TextLM, dtype=torch.float32))


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_generate_std_sent_matches_jax(lm_checkpoints, fp32_text_lms, tmp_path, family):
    ann = tmp_path / "ann.csv"
    with open(ann, "w", newline="") as f:
        w = csv.DictWriter(f, ["frame_path", "narration_text", "structured_verb", "structured_noun"])
        w.writeheader()
        for i, (verb, noun) in enumerate((("cut_(slice)", "onion_(bulb)"), ("", "x"), ("take", "knife"),
                                          ("wash", "plate_(dish)"), ("open", ""))):
            w.writerow(dict(frame_path=f"v|{i}", narration_text=f"#C C does {i}", structured_verb=verb,
                            structured_noun=noun))
    argv = ["--model", lm_checkpoints[family], "--annotation", str(ann), "--batch_size", "2",
            "--max_new_tokens", "6"]
    rows = generate_std_sent.main(argv + ["--annotation_with_std_sent", str(tmp_path / "ours.csv"),
                                          "--device", "cpu"])
    run_jax_script("scripts/ego4d/generate_std_sent.py", argv + ["--annotation_with_std_sent",
                                                                 str(tmp_path / "ref.csv")])
    ours = _rows(tmp_path / "ours.csv")
    assert ours == _rows(tmp_path / "ref.csv") and len(ours) == len(rows) == 3
    assert list(ours[0]) == ["frame_path", "narration_text", "structured_verb", "structured_noun"]
    assert all(r["narration_text"].endswith(".") for r in ours)


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_transform_to_full_sent_matches_jax(lm_checkpoints, fp32_text_lms, tmp_path, family):
    ann = tmp_path / "ann.csv"
    with open(ann, "w", newline="") as f:
        w = csv.DictWriter(f, ["video_id", "narration", "verb", "noun"])
        w.writeheader()
        for i, phrase in enumerate(("open door", "put down the plate", "wash carrot")):
            w.writerow(dict(video_id=f"P01_0{i}", narration=phrase, verb=phrase.split()[0],
                            noun=phrase.split()[-1]))
    argv = ["--model", lm_checkpoints[family], "--annotation", str(ann), "--batch_size", "2",
            "--max_new_tokens", "6"]
    transform_to_full_sent.main(argv + ["--output", str(tmp_path / "ours.csv"), "--device", "cpu"])
    run_jax_script("scripts/epic_kitchens/transform_to_full_sent.py", argv + ["--output",
                                                                              str(tmp_path / "ref.csv")])
    ours = _rows(tmp_path / "ours.csv")
    assert ours == _rows(tmp_path / "ref.csv") and len(ours) == 3
    assert list(ours[0]) == ["video_id", "narration", "verb", "noun", "full_sent_narration"]


def test_explore_data_matches_jax(fho_world, tmp_path, capsys):
    fho = json.loads((fho_world / "fho_main.json").read_text())
    for v in fho["videos"]:
        for j, a in enumerate(v["annotated_intervals"][0]["narrated_actions"]):
            a.update(start_sec=float(j), clip_start_sec=float(j) + (0.5 if j == 2 else 0.0),
                     clip_end_sec=float(j) + (9.0 if j % 3 == 0 else 4.0), freeform_verb="grabs")
    fho["videos"][0]["annotated_intervals"][0]["narrated_actions"][0]["is_valid_action"] = False
    fho["videos"][1]["annotated_intervals"][0]["narrated_actions"][1]["narration_text"] = "someone does it"
    (fho_world / "fho_main2.json").write_text(json.dumps(fho))
    (fho_world / "tax.json").write_text(json.dumps({"verbs": ["take"], "nouns": ["knife"]}))
    argv = ["--fho_main", str(fho_world / "fho_main2.json"), "--fho_lta_taxonomy", str(fho_world / "tax.json"),
            "--top", "5"]
    capsys.readouterr()
    report = explore_data.main(argv + ["--plot", str(tmp_path / "ours")])
    ours_out = capsys.readouterr().out
    run_jax_script("scripts/explore_data.py", argv + ["--plot", str(tmp_path / "ref")])
    ref_out = capsys.readouterr().out
    assert ours_out.replace(str(tmp_path / "ours"), "P") == ref_out.replace(str(tmp_path / "ref"), "P")
    assert report["total_actions"] == 21 and report["inconsistent_valid_rejected"] == 1
    assert report["accepted_non_camera_wearer"] == 1 and report["timestamp_mismatches"] == 4
    assert report["taxonomy"]["verbs_outside_taxonomy"] == ["cut"]
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref")) == [
        "action_durations.png", "top_structured_nouns.png", "top_structured_verbs.png"]


def test_select_qualitative_examples_matches_jax(tmp_path):
    combined = tmp_path / "combined.jsonl"
    with open(combined, "w") as f:
        for generated, truth, extra in (("The camera wearer cuts.", "The camera wearer cuts.", {}),
                                        ("The camera wearer opens a door.", "The camera wearer cuts an onion.", {}),
                                        ("x", "y", {"rougeL": 0.95}), ("a b", "a c", {})):
            f.write(json.dumps({"generated": generated, "ground_truth": truth, **extra}) + "\n")
    for above, threshold in ((True, "0.9"), (False, "0.5")):
        argv = ["--combined_jsonl", str(combined), "--threshold", threshold] + (["--above"] if above else [])
        kept = select_qualitative_examples.main(argv + ["--output", str(tmp_path / "ours.jsonl")])
        run_jax_script("scripts/select_qualitative_examples.py", argv + ["--output", str(tmp_path / "ref.jsonl")])
        assert (tmp_path / "ours.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
        assert kept == 2


# one figure of each kind: an ICL table's models (a subset, and all), an
# ablation pair, the shuffle bars
FIGURES = ["held-out-t5", "novel", "ablation-skewed", "shuffle"]


def test_plot_results_matches_jax(tmp_path):
    """A figure of each mode, and the single-curve mode with and without the
    published curve: the port's PNG byte-equal to the JAX script's."""
    for shot, v in ((0, 0.2), (16, 0.6)):
        (tmp_path / f"r{shot}.json").write_text(json.dumps({"rougeL": v, "bleu": v / 2}))
    results = [f"0={tmp_path}/r0.json", f"16={tmp_path}/r16.json"]
    csv_path = tmp_path / "narrated_actions.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["structured_verb", "structured_noun"])
        w.writeheader()
        for verb, noun, n in (("take", "knife", 5), ("cut", "onion", 2), ("open", "door", 1)):
            w.writerows([{"structured_verb": verb, "structured_noun": noun}] * n)
    cases = [["--figure", f, "--metric", "ROUGE-L", *results] for f in FIGURES]
    cases += [["--metric", "rougeL", "--with_published", *results], ["--metric", "bleu", *results],
              ["--figure", "action-freq", str(csv_path)]]
    for i, argv in enumerate(cases):
        ours = plot_results.main(argv + ["--out", str(tmp_path / f"ours{i}.png")])
        run_jax_script("scripts/plot_results.py", argv + ["--out", str(tmp_path / f"ref{i}.png")])
        assert open(ours, "rb").read() == (tmp_path / f"ref{i}.png").read_bytes(), argv


def test_plot_results_tsne(tmp_path):
    rng = np.random.default_rng(0)
    for label in ("ego4d", "ek"):
        np.save(tmp_path / f"{label}_embs.npy", rng.normal(size=(40, 16)).astype(np.float32))
    out = plot_results.main(["--figure", "tsne", f"ego4d={tmp_path}/ego4d", f"ek={tmp_path}/ek",
                             "--out", str(tmp_path / "tsne.png")])
    assert os.path.getsize(out) > 1000
