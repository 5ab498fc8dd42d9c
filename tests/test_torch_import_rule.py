"""The port never imports jax, flax or the JAX package."""

import re
import subprocess
import sys
from pathlib import Path


PORT_MODULES = [
    "eilev_tpu_torch",
    "eilev_tpu_torch.configs",
    "eilev_tpu_torch.ops",
    "eilev_tpu_torch.ops._build",
    "eilev_tpu_torch.ops.attention",
    "eilev_tpu_torch.ops.decode_attention",
    "eilev_tpu_torch.ops.dropout",
    "eilev_tpu_torch.ops.flash_attention",
    "eilev_tpu_torch.ops.fused_attention",
    "eilev_tpu_torch.ops.fused_mlp",
    "eilev_tpu_torch.ops.gelu",
    "eilev_tpu_torch.ops.preprocess",
    "eilev_tpu_torch.ops.quantization",
    "eilev_tpu_torch.models",
    "eilev_tpu_torch.models.auto",
    "eilev_tpu_torch.models.convert",
    "eilev_tpu_torch.models.llama",
    "eilev_tpu_torch.models.mixed_precision",
    "eilev_tpu_torch.models.opt",
    "eilev_tpu_torch.models.processing",
    "eilev_tpu_torch.models.qformer",
    "eilev_tpu_torch.models.safetensors_io",
    "eilev_tpu_torch.models.t5",
    "eilev_tpu_torch.models.video_blip",
    "eilev_tpu_torch.models.video_blip_v1",
    "eilev_tpu_torch.models.vision",
    "eilev_tpu_torch.generation",
    "eilev_tpu_torch.generation.config",
    "eilev_tpu_torch.generation.decoding",
    "eilev_tpu_torch.generation.logits",
    "eilev_tpu_torch.generation.speculative",
    "eilev_tpu_torch.generation.text_lm",
    "eilev_tpu_torch.generation.classify",
    "eilev_tpu_torch.serving",
    "eilev_tpu_torch.serving.feature_cache",
    "eilev_tpu_torch.data",
    "eilev_tpu_torch.data.clip_sampler",
    "eilev_tpu_torch.data.collate",
    "eilev_tpu_torch.data.frame",
    "eilev_tpu_torch.data.prompts",
    "eilev_tpu_torch.data.text",
    "eilev_tpu_torch.data.video_datasets",
    "eilev_tpu_torch.native",
    "eilev_tpu_torch.native.decoder",
    "eilev_tpu_torch.eval",
    "eilev_tpu_torch.eval.icl",
    "eilev_tpu_torch.eval.metrics",
    "eilev_tpu_torch.training",
    "eilev_tpu_torch.training.checkpoint",
    "eilev_tpu_torch.training.data_module",
    "eilev_tpu_torch.training.train_state",
    "eilev_tpu_torch.training.trainer",
    "eilev_tpu_torch.utils",
    "eilev_tpu_torch.utils.logging",
    "eilev_tpu_torch.utils.meters",
    "eilev_tpu_torch.cli",
    "eilev_tpu_torch.cli.generate_narration_texts",
    "eilev_tpu_torch.cli.icl_eval",
    "eilev_tpu_torch.cli.train_v2",
    "eilev_tpu_torch.samples",
    "eilev_tpu_torch.samples.eilev_generate_action_narration",
    "eilev_tpu_torch.samples.video_blip_generate_action_narration",
]

_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "eilev_tpu"))
print("FORBIDDEN:" + ",".join(bad))
"""


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *PORT_MODULES],
        cwd=root, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "FORBIDDEN:", proc.stdout


def test_every_port_module_is_probed():
    """PORT_MODULES lists every module of the package, so a new one cannot
    slip past the probe."""
    root = Path(__file__).resolve().parents[1]
    found = set()
    for path in (root / "eilev_tpu_torch").rglob("*.py"):
        parts = path.relative_to(root).with_suffix("").parts
        found.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert found <= set(PORT_MODULES), sorted(found - set(PORT_MODULES))


def test_chip_smoke_imports_no_jax():
    """The on-card smoke script is jax-free too (checked from its source: it
    raises at once without a card)."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|eilev_tpu)\b", re.MULTILINE)
    assert not banned.findall(src)
