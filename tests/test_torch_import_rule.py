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
