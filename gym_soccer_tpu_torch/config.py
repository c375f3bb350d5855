"""Static environment configuration (a copy of gym_soccer_tpu/config.py).

Frozen + hashable so it can key the per-configuration caches of host
tables and device lookup arrays, while still supporting the generalized
Littman-soccer family (arbitrary width/height/slip; reference ctor
contract: gym_soccer/envs/soccer_simultaneous_env.py:35-61).
"""
from __future__ import annotations

import dataclasses

# Action encoding (reference soccer_simultaneous_env.py:8-13).
NOOP, NORTH, SOUTH, EAST, WEST = 0, 1, 2, 3, 4
ACTION_STRING = ("NOOP", "NORTH", "SOUTH", "EAST", "WEST")
# Intended displacement per action as (dcol, drow)
# (reference ACTION_INT_TO_MOVE, soccer_simultaneous_env.py:24-30).
MOVES = ((0, 0), (0, -1), (0, 1), (1, 0), (-1, 0))
N_ACTIONS = 5
# Per joint action there are 9 slip combinations x at most 4 collision
# outcomes => at most 36 entries in the ordered, unmerged transition list
# (reference slip expansion :209-223, collision outcomes :296-362).
N_COMBOS = 9
N_OUTCOMES = 4
MAX_TRANSITIONS = N_COMBOS * N_OUTCOMES

TERMINAL_STATE = (-1, -1, -1, -1, -1)


def orthogonal_moves(move):
    """Orthogonal slip displacements, in the reference's order
    (soccer_simultaneous_env.py:205-206).  NOOP's 'slips' are NOOP itself,
    which is why standing never slips."""
    mc, mr = move
    return ((-mr, mc), (mr, -mc))


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Geometry + dynamics parameters (all static under jit).

    ``width``/``height`` follow the reference ctor: ``width`` counts playable
    columns; two goal columns are added internally (reference :48).
    """
    width: int = 5
    height: int = 4
    slip_prob: float = 0.0
    max_steps: int = 100  # hardcoded truncation in the reference (:404)

    def __post_init__(self):
        if self.width < 5:
            raise AssertionError("Width must be at least 5 columns.")
        if self.height < 4:
            raise AssertionError("Height must be at least 4 rows.")

    @property
    def W(self) -> int:
        """Internal width including the two goal columns."""
        return self.width + 2

    @property
    def H(self) -> int:
        return self.height

    @property
    def goal_rows(self):
        """Reference :60."""
        h = self.H
        if h % 2 == 0:
            return (((h - 1) // 2), h // 2)
        return (h // 2 - 1, h // 2, h // 2 + 1)

    @property
    def goal_cols(self):
        return (0, self.W - 1)

    @property
    def goal_row_bounds(self):
        """Goal rows are always a contiguous range; (lo, hi) inclusive.
        Membership tests use this form so the rules kernel works with both
        static configs and per-lane geometry arrays (core/multigrid.py)."""
        rows = self.goal_rows
        return rows[0], rows[-1]

    @property
    def n_raw(self) -> int:
        """Size of the raw mixed-radix state code space."""
        return self.H * self.W * self.H * self.W * 2

    def combo_probs(self):
        """The 9 slip-combination probabilities in list order, computed with
        the reference's exact float64 expressions (:209-223) so downstream
        cumulative sums are bit-identical."""
        q = float(self.slip_prob)
        return (
            (1 - q) * (1 - q),
            (1 - q) * q * 0.5,
            (1 - q) * q * 0.5,
            q * (1 - q) * 0.5,
            q * (1 - q) * 0.5,
            q * q * 0.25,
            q * q * 0.25,
            q * q * 0.25,
            q * q * 0.25,
        )


# Which movement variant (0=intended, 1=orthogonal slip 0, 2=orthogonal
# slip 1) each of the 9 combos uses, for player A and B respectively,
# in the reference's enumeration order (:209-223).
COMBO_VARIANT_A = (0, 0, 0, 1, 2, 1, 1, 2, 2)
COMBO_VARIANT_B = (0, 1, 2, 0, 0, 1, 2, 1, 2)
