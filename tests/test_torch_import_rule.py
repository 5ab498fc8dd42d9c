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
