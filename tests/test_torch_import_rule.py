"""The port never imports jax, flax or the JAX package."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path


def _port_modules() -> list[str]:
    """Every module of the package, found by walking it (so a new module
    cannot be missed); the walk imports only the packages, which import no
    jax either."""
    import eilev_tpu_torch

    return ["eilev_tpu_torch"] + sorted(
        info.name for info in pkgutil.walk_packages(eilev_tpu_torch.__path__, prefix="eilev_tpu_torch.")
    )


PORT_MODULES = _port_modules()

_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "eilev_tpu"))
print("FORBIDDEN:" + ",".join(bad))
late = sorted(m for m in sys.modules if m.split(".")[0] in ("transformers", "safetensors", "spacy"))
print("IMPORTED_AT_USE:" + ",".join(late))
"""


def test_port_imports_no_jax():
    assert "eilev_tpu_torch.parallel.tensor" in PORT_MODULES  # tensor parallelism's layout and collectives
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *PORT_MODULES],
        cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-2] == "FORBIDDEN:", proc.stdout


EVAL_SLICE = {
    "eilev_tpu_torch.eval.encoder", "eilev_tpu_torch.eval.published", "eilev_tpu_torch.models.videomae",
    "eilev_tpu_torch.cli.generation_eval", "eilev_tpu_torch.cli.sample_in_context_examples",
    "eilev_tpu_torch.cli.verify_quality", "eilev_tpu_torch.cli.train_v1", "eilev_tpu_torch.cli.get_vision_model_embs",
    "eilev_tpu_torch.cli.baselines.videomae_train", "eilev_tpu_torch.cli.baselines.videomae_predict",
    "eilev_tpu_torch.cli.baselines.videomae_generate_full_sent",
    "eilev_tpu_torch.cli.baselines.majority_generate_full_sent", "eilev_tpu_torch.cli.baselines.majority_predict",
}


def test_eval_slice_modules_import_no_transformers():
    """The evaluation encoders, VideoMAE, the baselines and their CLIs are
    among the probed modules, and importing them (with the rest of the port)
    loads neither transformers nor safetensors nor spaCy: the card has no
    transformers and no safetensors, so each is imported where it is used
    (a tokenizer load), or not at all (safetensors: models/safetensors_io.py)."""
    assert EVAL_SLICE <= set(PORT_MODULES), sorted(EVAL_SLICE - set(PORT_MODULES))
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *sorted(EVAL_SLICE)],
        cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-2:] == ["FORBIDDEN:", "IMPORTED_AT_USE:"], proc.stdout


def test_every_port_module_is_probed():
    """PORT_MODULES holds every module file of the package (the walk finds a
    module only inside a package with an ``__init__.py``), the serving
    slice's among them, so none slips past the probe."""
    root = Path(__file__).resolve().parents[1]
    found = set()
    for path in (root / "eilev_tpu_torch").rglob("*.py"):
        parts = path.relative_to(root).with_suffix("").parts
        found.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert found <= set(PORT_MODULES), sorted(found - set(PORT_MODULES))
    assert {"eilev_tpu_torch.serving.engine", "eilev_tpu_torch.serving.session", "eilev_tpu_torch.cli.serve",
            "eilev_tpu_torch.demo.eilev_demo"} <= set(PORT_MODULES)


def test_chip_smoke_imports_no_jax():
    """The on-card smoke script is jax-free too (checked from its source: it
    raises at once without a card)."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|eilev_tpu)\b", re.MULTILINE)
    assert not banned.findall(src)


# the data-preparation, sentence and analysis tools, the v1 chat demo and the
# job generators
DATA_TOOLS = {
    "eilev_tpu_torch.cli.ego4d.extract_frames", "eilev_tpu_torch.cli.ego4d.split_train_val_test",
    "eilev_tpu_torch.cli.ego4d.add_structured_verb_noun", "eilev_tpu_torch.cli.ego4d.generate_std_sent",
    "eilev_tpu_torch.cli.epic_kitchens.epic_kitchens_extract_frames",
    "eilev_tpu_torch.cli.epic_kitchens.transform_to_full_sent", "eilev_tpu_torch.demo.video_blip_demo",
    "eilev_tpu_torch.cli.explore_data", "eilev_tpu_torch.cli.select_qualitative_examples",
    "eilev_tpu_torch.cli.plot_results", "eilev_tpu_torch.launch.launch_lib",
    "eilev_tpu_torch.launch.submit_extract_frames", "eilev_tpu_torch.launch.submit_generate_full_sent",
    "eilev_tpu_torch.launch.submit_generate_narration_texts", "eilev_tpu_torch.launch.submit_icl_eval",
    "eilev_tpu_torch.launch.submit_train_v2", "eilev_tpu_torch.launch.submit_videomae_train",
}


def test_data_tools_import_no_jax_and_no_optional_packages():
    """Every new tool is probed, and importing them loads no jax, flax or
    eilev_tpu, nor transformers, safetensors or spaCy (neither is on the
    card's host: a tokenizer is loaded where it is used), nor matplotlib or
    scikit-learn (imported where a figure is drawn)."""
    assert DATA_TOOLS <= set(PORT_MODULES), sorted(DATA_TOOLS - set(PORT_MODULES))
    root = Path(__file__).resolve().parents[1]
    probe = _PROBE + 'print("PLOTTING:" + ",".join(sorted(m for m in sys.modules if m.split(".")[0] in '
    probe += '("matplotlib", "sklearn"))))\n'
    proc = subprocess.run([sys.executable, "-c", probe, *sorted(DATA_TOOLS)], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-3:] == ["FORBIDDEN:", "IMPORTED_AT_USE:", "PLOTTING:"], proc.stdout


def test_device_entry_points_default_to_the_card():
    """The tools that compute on a device run on the card unless asked for
    the CPU."""
    from eilev_tpu_torch.cli.ego4d import extract_frames, generate_std_sent
    from eilev_tpu_torch.cli.epic_kitchens import epic_kitchens_extract_frames, transform_to_full_sent
    from eilev_tpu_torch.demo import video_blip_demo

    required = {
        extract_frames: ["--fho_main_path", "f", "--split_path", "s", "--video_dir_path", "v", "--frames_dir", "o",
                         "--num_subsample_frames", "8"],
        epic_kitchens_extract_frames: ["--annotation_path", "a", "--epic_kitchens_55_video_dir_path", "a",
                                       "--epic_kitchens_100_video_dir_path", "b", "--frames_dir", "o",
                                       "--num_subsample_frames", "8"],
        generate_std_sent: ["--model", "m", "--annotation", "a", "--annotation_with_std_sent", "o"],
        transform_to_full_sent: ["--model", "m", "--annotation", "a", "--output", "o"],
        video_blip_demo: ["--model", "m"],
    }
    for module, argv in required.items():
        assert module.parse_args(argv).device == "cuda", module.__name__
        assert module.parse_args(argv + ["--device", "cpu"]).device == "cpu"
    assert video_blip_demo.LavisChat.__init__.__defaults__ == ("cuda",)
