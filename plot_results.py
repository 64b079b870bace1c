"""Benchmark result plots — the reference's analysis notebook as a script.

Replaces generate_results_plots.ipynb: loads ``data/<model>_benchmark.csv``
files (reference schema: line 1 sizes, line 2 stage-1 seconds, optional
line 3 stage-2 seconds), plots runtime curves and speedups relative to the
optimized single-core model, and writes PNGs under ``results/``.

Usage: python plot_results.py [--data data] [--out results]
"""

import argparse
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

MODELS = [
    "base",
    "singlecore",
    "multicore",
    "tpu1",
    "tpu2",
    "jacobi",
    "diagonal",
    "diagonal_qr",
]


def load_csv(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) < 2:
        return None
    sizes = [int(x) for x in lines[0].split(",")]
    t1 = [float(x) for x in lines[1].split(",")]
    t2 = [float(x) for x in lines[2].split(",")] if len(lines) > 2 else None
    return sizes, t1, t2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="data")
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    results = {}
    for m in MODELS:
        path = os.path.join(args.data, f"{m}_benchmark.csv")
        if os.path.exists(path) and os.path.getsize(path) > 0:
            parsed = load_csv(path)
            if parsed:
                results[m] = parsed
    if not results:
        print("no benchmark CSVs found; run `python -m svdsolver_tpu bench` first")
        return

    # runtime curves (two-stage models: total = stage1 + stage2)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for m, (sizes, t1, t2) in results.items():
        total = [a + b for a, b in zip(t1, t2)] if t2 else t1
        ax.plot(sizes, total, marker="o", label=m)
    ax.set_xlabel("matrix size N")
    ax.set_ylabel("mean seconds per instance")
    ax.set_yscale("log")
    ax.set_title("SVD model runtimes")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    p1 = os.path.join(args.out, "runtimes.png")
    fig.savefig(p1, dpi=120)
    print(f"wrote {p1}")

    # speedup vs the optimized single-core model (as in the notebook)
    if "singlecore" in results:
        ssizes, st1, _ = results["singlecore"]
        base = dict(zip(ssizes, st1))
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for m, (sizes, t1, t2) in results.items():
            if m == "singlecore":
                continue
            total = [a + b for a, b in zip(t1, t2)] if t2 else t1
            pts = [(n, base[n] / t) for n, t in zip(sizes, total) if n in base and t > 0]
            if pts:
                ax.plot(*zip(*pts), marker="s", label=m)
        ax.axhline(1.0, color="gray", lw=0.8)
        ax.set_xlabel("matrix size N")
        ax.set_ylabel("speedup vs singlecore")
        ax.set_title("Speedup relative to optimized single-core model")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        p2 = os.path.join(args.out, "speedup.png")
        fig.savefig(p2, dpi=120)
        print(f"wrote {p2}")

    # stage split for two-stage models
    two_stage = {m: r for m, r in results.items() if r[2]}
    if two_stage:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for m, (sizes, t1, t2) in two_stage.items():
            ax.plot(sizes, t1, marker="o", label=f"{m} stage I (dense->band)")
            ax.plot(sizes, t2, marker="^", ls="--", label=f"{m} stage II (band->bidiag)")
        ax.set_xlabel("matrix size N")
        ax.set_ylabel("mean seconds per instance")
        ax.set_yscale("log")
        ax.set_title("Two-stage split")
        ax.legend(fontsize=8)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        p3 = os.path.join(args.out, "stages.png")
        fig.savefig(p3, dpi=120)
        print(f"wrote {p3}")


if __name__ == "__main__":
    main()
