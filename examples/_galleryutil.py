"""Shared helpers for the figure-producing example gallery.

Figures save to ``examples/out/`` (created on demand) with the Agg backend,
so every study runs headless; ``docs/GALLERY.md`` links the outputs.
Each gallery script calls ``enable_cache()`` first under ``__main__``, so a
rerun loads its compiled solvers from JAX's persistent cache.
"""

import os

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def enable_cache():
    from accbpg_and_fw_tpu.compile_cache import enable_compilation_cache

    return enable_compilation_cache()


def get_axes(nrows=1, ncols=1, figsize=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matplotlib.rcParams.update({"font.size": 12, "font.family": "serif"})
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize
                             or (5.5 * ncols, 4.2 * nrows))
    return fig, axes


def save_fig(fig, name):
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    print(f"saved {path}")
    return path
