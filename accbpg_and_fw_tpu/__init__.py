"""accbpg_and_fw_tpu — relatively-smooth convex optimization in JAX.

A JAX/XLA framework with the capabilities of
``DredderGun/accbpg_and_fw``: Bregman proximal-gradient methods (BPG, ABPG,
ABPG-expo, ABPG-gain, ABDA, AIBM, AdaptFGM, UniversalGM, a primal-dual
switching method), Frank-Wolfe methods with Bregman divergences and
(L0,L1)-smoothness step rules, and specialized D-optimal-design solvers —
with iteration loops compiled as ``lax.scan`` kernels and problems sharded
over device meshes.  It runs on NVIDIA GPUs and on the CPU; the package
name is kept for import compatibility.

The public API mirrors the reference's (same names, signatures and return
tuples; see the reference's accbpg/__init__.py) so user scripts port with
an import change.
"""

__version__ = "0.1.0"

from .ops import *  # noqa: F401,F403  (oracle layer: f/h oracles + LMOs)
from .ops import __all__ as _ops_all
from .algorithms import *  # noqa: F401,F403  (iteration drivers)
from .algorithms import __all__ as _alg_all
from .apps import *  # noqa: F401,F403  (problem factories + utils)
from .apps import __all__ as _apps_all
from .viz import *  # noqa: F401,F403  (plot_comparisons, plotTSE)
from .viz import __all__ as _viz_all
from . import diagnostics, parallel  # noqa: F401  (submodule access)

__all__ = list(_ops_all) + list(_alg_all) + list(_apps_all) + list(_viz_all)
