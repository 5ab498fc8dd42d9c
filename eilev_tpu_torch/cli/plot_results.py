"""Analysis figures, one command a figure of the original's notebooks
(counterpart of ``scripts/plot_results.py``).

  icl_eval_figures.ipynb           -> --figure held-out-opt | held-out-t5 |
                                      epic-kitchens-opt | epic-kitchens-t5 | novel
  ablation_figures.ipynb           -> --figure ablation-bursty | ablation-skewed |
                                      ablation-dynamic
  shuffle_in_context_figures.ipynb -> --figure shuffle
  tsne_ego4d_epic_kitchens.ipynb   -> --figure tsne LABEL=EMB_PREFIX ...
                                      (cli/get_vision_model_embs output:
                                      <prefix>_embs.npy + _index.json)
  skewed_dist_figures.ipynb        -> --figure action-freq over narrated_actions.csv files

The published curves are those of ``eval/published.py``; your own results
(``cli/generation_eval --output_json`` files) can be overlaid on any metric
figure as SHOT=PATH pairs:

    python -m eilev_tpu_torch.cli.plot_results --figure held-out-opt --metric ROUGE-L \\
        0=eval-0shot.json 16=eval-16shot.json --out held_out.png

Without --figure, one curve of your results (--with_published adds the
published EILeV OPT-2.7B curve):

    python -m eilev_tpu_torch.cli.plot_results --metric rougeL 0=a.json 16=b.json \\
        --with_published --out rougeL.png

Host only; needs matplotlib (and scikit-learn for --figure tsne).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from ..eval.published import (
    ABLATION_CURVES,
    ICL_CURVES,
    METRIC_KEYS,
    SHUFFLE_RAW,
    SHUFFLE_SHOTS,
    shuffle_percent_diff,
)

# per-figure model lists, matching the notebooks' draw_graphs calls
_ICL_FIGURES = {
    "held-out-opt": ("ego4d-held-out", [
        "EILEV BLIP-2 OPT-2.7B", "VideoMAE-huge", "BLIP-2 OPT-2.7B", "FT BLIP-2 OPT-2.7B",
    ]),
    "held-out-t5": ("ego4d-held-out", [
        "EILEV BLIP-2 Flan-T5-xl", "VideoMAE-huge", "BLIP-2 Flan-T5-xl", "FT BLIP-2 Flan-T5-xl",
    ]),
    "epic-kitchens-opt": ("epic-kitchens", [
        "EILEV BLIP-2 OPT-2.7B", "VideoMAE-huge", "BLIP-2 OPT-2.7B", "FT BLIP-2 OPT-2.7B",
    ]),
    "epic-kitchens-t5": ("epic-kitchens", [
        "EILEV BLIP-2 Flan-T5-xl", "VideoMAE-huge", "BLIP-2 Flan-T5-xl", "FT BLIP-2 Flan-T5-xl",
    ]),
    "novel": ("novel-rare", None),  # all models in the table
}

_ABLATION_FIGURES = {
    "ablation-bursty": ["eilev", "bursty"],
    "ablation-skewed": ["skewed-eilev", "skewed-ablation"],
    "ablation-dynamic": ["eilev", "dynamic"],
}


def _load_results(pairs, metric):
    """SHOT=PATH generation_eval JSONs -> sorted (shots, values)."""
    ours_key = {v: k for k, v in METRIC_KEYS.items()}.get(metric, metric)
    shots, values = [], []
    for pair in pairs:
        shot, path = pair.split("=", 1)
        with open(path) as f:
            data = json.load(f)
        key = metric if metric in data else ours_key
        if key not in data:
            raise SystemExit(f"{path} has no metric {metric!r}/{ours_key!r}; keys: {list(data)}")
        shots.append(int(shot))
        values.append(float(data[key]))
    order = sorted(range(len(shots)), key=lambda i: shots[i])
    return [shots[i] for i in order], [values[i] for i in order]


def _plot_curves(ax, curves_by_model, metric, ours=None):
    for model, curves in curves_by_model.items():
        if metric not in curves:
            continue
        pts = sorted(curves[metric].items())
        style = "-" if model.startswith("EILEV") else "--"
        marker = "o" if model.startswith("EILEV") else "s"
        ax.plot([s for s, _ in pts], [v for _, v in pts],
                marker=marker, linestyle=style, label=model)
    if ours:
        ax.plot(ours[0], ours[1], marker="*", markersize=12, linewidth=2,
                color="black", label="this framework")
    ax.set_xlabel("number of in-context examples (shots)")
    ax.set_ylabel(metric)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results", nargs="*",
                   help="SHOT=PATH result JSONs (metric figures) or "
                        "LABEL=EMB_PREFIX pairs (--figure tsne) or CSV paths "
                        "(--figure action-freq)")
    p.add_argument("--figure", default=None,
                   choices=sorted(list(_ICL_FIGURES) + list(_ABLATION_FIGURES)
                                  + ["shuffle", "tsne", "action-freq"]))
    p.add_argument("--metric", default="rougeL",
                   help="ours (rougeL/bleu/sts_biencoder/...) or notebook "
                        "(ROUGE-L/BLEU/STS-BE/STS-CE/BERTScore-F1) name")
    p.add_argument("--with_published", action="store_true",
                   help="(no --figure) overlay the published EILeV OPT-2.7B curve")
    p.add_argument("--max_points", type=int, default=20000,
                   help="tsne: subsample per dataset (notebook uses 20k)")
    p.add_argument("--title", default=None)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> str:
    """Draw the figure into ``--out``; returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metric = METRIC_KEYS.get(args.metric, args.metric)

    if args.figure in _ICL_FIGURES:
        table, models = _ICL_FIGURES[args.figure]
        curves = ICL_CURVES[table]
        if models is not None:
            curves = {m: curves[m] for m in models if m in curves}
        ours = _load_results(args.results, metric) if args.results else None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        _plot_curves(ax, curves, metric, ours)
        ax.set_title(args.title or f"{args.figure}: {metric}")

    elif args.figure in _ABLATION_FIGURES:
        merged = {}
        for key in _ABLATION_FIGURES[args.figure]:
            merged.update(ABLATION_CURVES[key])
        ours = _load_results(args.results, metric) if args.results else None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        _plot_curves(ax, merged, metric, ours)
        ax.set_title(args.title or f"{args.figure}: {metric}")

    elif args.figure == "shuffle":
        # percent diff shuffled-vs-ordered per model family (notebook cell 1)
        fams = [
            ("blip_2_opt_27b", "BLIP-2 OPT-2.7B"),
            ("blip_2_flan_t5_xl", "BLIP-2 Flan-T5-xl"),
            ("eilev_blip_2_opt_27b", "EILEV BLIP-2 OPT-2.7B"),
            ("eilev_blip_2_flan_t5_xl", "EILEV BLIP-2 Flan-T5-xl"),
        ]
        fig, axs = plt.subplots(1, len(fams), figsize=(4 * len(fams), 4),
                                sharex=True, sharey=True)
        for ax, (key, label) in zip(axs, fams):
            diff = shuffle_percent_diff(key, metric if metric in SHUFFLE_RAW[key] else "STS-BE")
            ax.bar([str(s) for s in SHUFFLE_SHOTS], diff)
            ax.axhline(0.0, color="black", linewidth=0.8)
            ax.set_title(label, fontsize=10)
            ax.set_xlabel("shots")
        axs[0].set_ylabel(f"% diff ({metric}) shuffled vs ordered")

    elif args.figure == "tsne":
        # tsne_ego4d_epic_kitchens.ipynb cells 2-4: PCA(50) then t-SNE over
        # vision-model embeddings, colored by dataset
        import numpy as np
        from sklearn.decomposition import PCA
        from sklearn.manifold import TSNE

        rng = np.random.default_rng(42)
        all_embs, labels = [], []
        for pair in args.results:
            label, prefix = pair.split("=", 1)
            embs = np.load(prefix + "_embs.npy")
            if len(embs) > args.max_points:
                embs = embs[rng.permutation(len(embs))[: args.max_points]]
            all_embs.append(embs)
            labels += [label] * len(embs)
        x = np.concatenate(all_embs).astype(np.float32)
        n_comp = min(50, x.shape[0], x.shape[1])
        x = PCA(n_components=n_comp).fit_transform(x)
        perplexity = min(30.0, max(2.0, (x.shape[0] - 1) / 3))
        pts = TSNE(perplexity=perplexity).fit_transform(x)
        fig, ax = plt.subplots(figsize=(8, 5))
        start = 0
        for embs, pair in zip(all_embs, args.results):
            label = pair.split("=", 1)[0]
            seg = pts[start : start + len(embs)]
            start += len(embs)
            ax.scatter(seg[:, 0], seg[:, 1], s=4, alpha=0.5, label=label,
                       rasterized=True)
        ax.legend()
        ax.set_title(args.title or "vision-embedding t-SNE")
        ax.set_xticks([])
        ax.set_yticks([])

    elif args.figure == "action-freq":
        # skewed_dist_figures.ipynb: action-frequency bar chart over
        # narrated_actions.csv files
        import csv
        from collections import Counter

        counter: Counter = Counter()
        for path in args.results:
            with open(path, newline="") as f:
                for item in csv.DictReader(f):
                    if item.get("structured_verb") and item.get("structured_noun"):
                        counter[(item["structured_verb"], item["structured_noun"])] += 1
        pairs = counter.most_common()
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.bar(range(len(pairs)), [c for _, c in pairs], width=1.0)
        ax.set_yscale("log")
        ax.set_xlabel("action rank")
        ax.set_ylabel("count (log)")
        ax.set_title(args.title or f"action frequency ({len(pairs)} actions)")

    else:  # round-2 single-curve mode
        shots, values = _load_results(args.results, metric)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(shots, values, marker="o", label="this framework")
        if args.with_published:
            pub = ICL_CURVES["ego4d-held-out"]["EILEV BLIP-2 OPT-2.7B"].get(metric, {})
            pts = sorted(pub.items())
            if pts:
                ax.plot([s for s, _ in pts], [v for _, v in pts], marker="s",
                        linestyle="--", label="EILeV OPT-2.7B (published)")
        ax.set_xlabel("number of in-context examples (shots)")
        ax.set_ylabel(metric)
        ax.set_title(args.title or f"{metric} vs shots")
        ax.legend()
        ax.grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(args.out, dpi=150)
    plt.close("all")
    print(f"wrote {args.out}")
    return args.out


def main(argv: Optional[list[str]] = None) -> str:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
