"""Drop-in compatibility alias: ``import accbpg`` -> accbpg_and_fw_tpu.

User scripts written against the reference package
(DredderGun/accbpg_and_fw's ``accbpg``) run unchanged on this JAX
framework: same public names, signatures, return tuples and progress
tables (see PARITY.md for the full component map and the golden trajectory
tests in tests/test_reference_parity.py for the equivalence evidence).
"""

from accbpg_and_fw_tpu import *  # noqa: F401,F403
from accbpg_and_fw_tpu import __all__, __version__  # noqa: F401
