"""wandb-compatible logging (counterpart of ``eilev_tpu/utils/logging.py``).

The original EILeV logs everything through wandb; the logger here uses wandb
when it is importable and its ``init`` succeeds, and prints to stdout
otherwise (no wandb, no network, or logging disabled).
"""

from __future__ import annotations

from typing import Any, Optional


def maybe_wandb():
    try:
        import wandb  # type: ignore

        return wandb
    except Exception:
        return None


class WandbLogger:
    """Callable logger: fn(step, metrics). Uses wandb when importable and
    initialized; otherwise prints."""

    def __init__(self, project: Optional[str] = None, config: Optional[dict] = None, enabled: bool = True):
        self._wandb = maybe_wandb() if enabled else None
        if self._wandb is not None:
            try:
                self._wandb.init(project=project, config=config)
            except Exception:
                self._wandb = None

    def __call__(self, step: int, metrics: dict[str, Any]) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        else:
            printable = {k: round(v, 5) if isinstance(v, float) else v for k, v in metrics.items()}
            print(f"[step {step}] {printable}")

    def log_table(self, name: str, columns: list[str], rows: list[list]) -> None:
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Table(columns=columns, data=rows)})
        else:
            print(f"[table {name}] {columns}")
            for r in rows[:5]:
                print("   ", r)
