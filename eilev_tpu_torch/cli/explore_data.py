"""Ego4D fho_main.json diagnostics (counterpart of ``scripts/explore_data.py``).

One report in place of the original's data-exploration notebooks:

  - annotation integrity: is_valid_action == is_rejected inconsistencies,
    accepted actions whose narration is not a camera-wearer '#C C ...' line,
    start/clip timestamp mismatches;
  - action duration statistics (the 8 s clip-window design input);
  - verb/noun distributions over filter_action-accepted actions
    (structured vs freeform), coverage against fho_lta_taxonomy.json;
  - optional --plot writes duration/verb/noun histograms (needs matplotlib).

Host only:

    python -m eilev_tpu_torch.cli.explore_data --fho_main fho_main.json \\
        [--fho_lta_taxonomy fho_lta_taxonomy.json] [--plot out_dir] [--top 20]
"""

from __future__ import annotations

import argparse
import json
import math
import os
from collections import Counter
from typing import Optional

from ..data.text import C_REGEX
from ..data.video_datasets import filter_action, get_structured_noun


def iter_actions(fho_main: dict):
    for video in fho_main["videos"]:
        for interval in video["annotated_intervals"]:
            yield from interval["narrated_actions"]


def analyze(fho_main: dict, taxonomy: Optional[dict] = None, top: int = 20) -> dict:
    """The report dict."""
    n_total = 0
    inconsistent_flags = 0
    accepted_non_c = 0
    timestamp_mismatch = 0
    durations = []
    struct_verbs: Counter = Counter()
    freeform_verbs: Counter = Counter()
    struct_nouns: Counter = Counter()
    kept = 0
    for action in iter_actions(fho_main):
        n_total += 1
        if action.get("is_valid_action") == action.get("is_rejected"):
            inconsistent_flags += 1
        if not action.get("is_rejected") and not C_REGEX.match(action.get("narration_text") or ""):
            accepted_non_c += 1
        if "start_sec" in action and "clip_start_sec" in action:
            if not math.isclose(action["start_sec"], action["clip_start_sec"], rel_tol=1e-5):
                timestamp_mismatch += 1
        if "clip_start_sec" in action and "clip_end_sec" in action:
            durations.append(action["clip_end_sec"] - action["clip_start_sec"])
        if not filter_action(action):
            continue
        kept += 1
        sv = action.get("structured_verb")
        if sv and sv != "[other]":
            struct_verbs[sv] += 1
        fv = action.get("freeform_verb")
        if fv:
            freeform_verbs[fv] += 1
        sn = get_structured_noun(action)
        if sn:
            struct_nouns[sn] += 1

    report = {
        "total_actions": n_total,
        "kept_by_filter": kept,
        "inconsistent_valid_rejected": inconsistent_flags,
        "accepted_non_camera_wearer": accepted_non_c,
        "timestamp_mismatches": timestamp_mismatch,
        "duration_sec": {
            "n": len(durations),
            "mean": sum(durations) / len(durations) if durations else None,
            "max": max(durations) if durations else None,
            "min": min(durations) if durations else None,
            "over_8s": sum(1 for d in durations if d > 8.0),
        },
        "top_structured_verbs": struct_verbs.most_common(top),
        "top_structured_nouns": struct_nouns.most_common(top),
        "n_unique_structured_verbs": len(struct_verbs),
        "n_unique_structured_nouns": len(struct_nouns),
    }
    if taxonomy is not None:
        tax_verbs = set(taxonomy["verbs"])
        tax_nouns = set(taxonomy["nouns"])
        report["taxonomy"] = {
            "n_taxonomy_verbs": len(tax_verbs),
            "n_taxonomy_nouns": len(tax_nouns),
            "verbs_outside_taxonomy": sorted(set(struct_verbs) - tax_verbs)[:top],
            "nouns_outside_taxonomy": sorted(set(struct_nouns) - tax_nouns)[:top],
        }
    return report


def plot(fho_main: dict, report: dict, out_dir: str) -> None:
    """The duration histogram and the top verb and noun bar charts as PNGs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    durations = [a["clip_end_sec"] - a["clip_start_sec"] for a in iter_actions(fho_main)
                 if "clip_start_sec" in a and "clip_end_sec" in a]
    fig, ax = plt.subplots()
    ax.hist(durations, bins=50)
    ax.set_xlabel("action duration (s)")
    ax.set_ylabel("count")
    fig.savefig(os.path.join(out_dir, "action_durations.png"), dpi=120)
    for key in ("top_structured_verbs", "top_structured_nouns"):
        pairs = report[key]
        if not pairs:
            continue
        labels = [k if len(k) <= 12 else k[:12] + "..." for k, _ in pairs]
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.bar(range(len(pairs)), [v for _, v in pairs])
        ax.set_xticks(range(len(pairs)), labels, rotation=60, ha="right")
        ax.set_title(key)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{key}.png"), dpi=120)
    plt.close("all")
    print(f"plots written to {out_dir}")


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fho_main", required=True)
    p.add_argument("--fho_lta_taxonomy", default=None)
    p.add_argument("--plot", default=None, help="directory for histogram PNGs")
    p.add_argument("--top", type=int, default=20)
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Print the report as JSON (and write the plots); returns it."""
    with open(args.fho_main) as f:
        fho_main = json.load(f)
    taxonomy = None
    if args.fho_lta_taxonomy:
        with open(args.fho_lta_taxonomy) as f:
            taxonomy = json.load(f)
    report = analyze(fho_main, taxonomy, top=args.top)
    print(json.dumps(report, indent=2))
    if args.plot:
        plot(fho_main, report, args.plot)
    return report


def main(argv: Optional[list[str]] = None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
