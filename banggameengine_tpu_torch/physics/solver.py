"""Contact-solver constants shared with the transposed pipeline.

The constants of ``banggameengine_tpu/physics/solver.py`` that
:mod:`contact_t` reads.  The general (``[..., 3]``-minor) solver is not
ported.
"""

BAUMGARTE = 0.2            # Bullet global ERP default
PENETRATION_SLOP = 0.005   # ~ Bullet linear slop
RESTITUTION_THRESHOLD = 1.0  # Bullet restitution velocity threshold
WARM_START_FACTOR = 0.85   # btContactSolverInfo m_warmstartingFactor
