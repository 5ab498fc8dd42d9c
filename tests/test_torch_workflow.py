"""The EILeV workflow on the port alone, in a process that loads no jax and
nothing of ``eilev_tpu`` (the host a card sits on has no jax): synthetic
Ego4D clips -> ``cli/ego4d/extract_frames.extract`` (PNG frames and
``narrated_actions.csv``) -> ``cli/ego4d/split_train_val_test`` -> the
split's train and test rows -> ``cli/sample_in_context_examples`` ->
``cli/generate_narration_texts`` (a tiny VideoBLIP checkpoint, fp32 on the
CPU) -> ``cli/generation_eval``. Each stage's output exists and parses; the
extraction CSV equals the JAX script's on the same annotation (decoded from
y4m videos by the JAX package, in this test's process), and the port's
process reports no jax, flax or ``eilev_tpu`` module. The port's
counterpart of ``tests/integration/test_full_pipeline.py``."""

import csv
import json
import os
import subprocess
import sys

from ._torch_hf import hf_config, write_checkpoint
from .test_torch_data_tools import run_jax_script, write_fho_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's side, in a process of its own: argv[1] the world's paths (JSON)
PORT_CHAIN = r'''
import csv, json, os, sys
import numpy as np
import torch

from eilev_tpu_torch.cli import generate_narration_texts, generation_eval, sample_in_context_examples
from eilev_tpu_torch.cli.ego4d import extract_frames, split_train_val_test
from eilev_tpu_torch.data.video_datasets import Ego4dFHOMainDataset

w = json.loads(sys.argv[1])
out = w["out"]
# synthetic clips in place of the decoder: one (C, T, H, W) uint8 clip a
# narrated action the dataset keeps, in its order
rng = np.random.default_rng(0)
dataset = Ego4dFHOMainDataset(w["fho_main"], w["split"], w["videos"], num_frames=4)
items = [dict(action, video_uid=ann["video_uid"], clip_index=i,
              video=rng.integers(0, 256, (3, 4, 24, 40), dtype=np.uint8))
         for _, ann in dataset._paths for i, action in enumerate(ann["narrated_actions"])]
frames = os.path.join(out, "frames")
args = extract_frames.parse_args(["--fho_main_path", w["fho_main"], "--split_path", w["split"],
                                  "--video_dir_path", w["videos"], "--frames_dir", frames,
                                  "--num_subsample_frames", "4", "--target_size", "32", "--device", "cpu"])
stats = extract_frames.extract(items, args, torch.device("cpu"))

splits = split_train_val_test.main([w["fho_main"], os.path.join(out, "splits"), w["videos"]])
with open(os.path.join(frames, "narrated_actions.csv"), newline="") as f:
    rows = list(csv.DictReader(f))
for name in ("train", "test"):
    with open(os.path.join(out, f"{name}.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, list(rows[0]))
        writer.writeheader()
        writer.writerows(r for r in rows if r["video_uid"] in splits[name])

icl_map = sample_in_context_examples.main([
    "--in_context_frames_dir", frames, "--in_context_annotation_file", os.path.join(out, "train.csv"),
    "--eval_frames_dir", frames, "--eval_annotation_file", os.path.join(out, "test.csv"),
    "--num_shot", "2", "--verb_noun_ratio", "0.5", "--output_prefix", os.path.join(out, "icl")])
generated = generate_narration_texts.main([
    "--model", w["checkpoint"], "--dtype", "fp32", "--device", "cpu", "--eval_frames_dir", frames,
    "--eval_annotation_file", os.path.join(out, "test.csv"), "--in_context_query_map_file", icl_map,
    "--in_context_example_frames_dir", frames,
    "--in_context_example_annotation_file", os.path.join(out, "train.csv"), "--batch_size", "2",
    "--generation_config", '{"max_new_tokens": 6}', "--output_csv", os.path.join(out, "generated.csv")])
metrics = generation_eval.main(["--input_csv", os.path.join(out, "generated.csv"),
                                "--output_json", os.path.join(out, "metrics.json"), "--device", "cpu"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "eilev_tpu"))
print("WORKFLOW " + json.dumps({"clips": stats["clips"], "splits": {k: len(v) for k, v in splits.items()},
                                "test_rows": sum(r["video_uid"] in splits["test"] for r in rows),
                                "generated": len(generated), "metrics": sorted(metrics), "loaded": loaded}))
'''


def test_workflow_without_jax(tmp_path):
    world = write_fho_world(tmp_path / "world", n_videos=4, n_actions=3)
    run_jax_script("scripts/ego4d/extract_frames.py",
                   ["--fho_main_path", world["fho_main"], "--split_path", world["split"],
                    "--video_dir_path", world["videos"], "--frames_dir", str(tmp_path / "ref"),
                    "--num_subsample_frames", "4", "--csv_only"])
    checkpoint = str(tmp_path / "checkpoint")
    write_checkpoint(checkpoint, hf_config(max_position_embeddings=512), seed=29, tokenizer=True)
    out = tmp_path / "port"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PORT_CHAIN,
                           json.dumps(dict(world, checkpoint=checkpoint, out=str(out)))],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("WORKFLOW ")]
    summary = json.loads(line[len("WORKFLOW "):])
    assert summary["loaded"] == [], summary["loaded"]

    with open(out / "frames" / "narrated_actions.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    ref = tmp_path / "ref" / "narrated_actions.csv"
    assert (out / "frames" / "narrated_actions.csv").read_bytes() == ref.read_bytes()
    assert summary["clips"] == len(rows) == 12
    assert all(len(os.listdir(out / "frames" / r["frame_path"])) == 4 for r in rows)
    for name in ("train", "val", "test"):
        split = json.loads((out / "splits" / f"fho_main_{name}.json").read_text())
        assert split["split"] == name
    assert sum(summary["splits"].values()) == 4
    maps = [json.loads(ln) for ln in (out / "icl-2-shot.jsonl").read_text().splitlines()]
    assert len(maps) == summary["test_rows"] > 0 and all(len(m["context"]) == 2 for m in maps)
    with open(out / "generated.csv", newline="") as f:
        generated = list(csv.DictReader(f))
    assert len(generated) == summary["generated"] == summary["test_rows"]
    assert {"frame_path", "generated", "ground_truth"} <= set(generated[0])
    metrics = json.loads((out / "metrics.json").read_text())
    assert sorted(metrics) == summary["metrics"] and "rougeL" in metrics
