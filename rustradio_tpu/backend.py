"""The one backend dispatch point.

Hand-written kernels run on the GPU; every other platform takes the plain
XLA form of the same op.  ``INTERPRET`` runs the kernels through the
Pallas interpreter on the CPU instead; only tests set it.
"""

from __future__ import annotations

import jax

INTERPRET = False


def use_kernels() -> bool:
    """True where the hand-written kernels run: the GPU, or the Pallas
    interpreter under tests.  Evaluated at trace time."""
    return INTERPRET or jax.default_backend() == "gpu"
