"""Regenerate tests/golden/render_golden.json: the reference's ``render()``
output, byte for byte, for a set of states and last actions, executed
under the gym stub ``refstub``; the twin of the JAX package's
tools/gen_render_golden.py.

``build`` renders the cases on any env class with the reference's
constructor; ``main`` hands it the reference's own, from the checkout
named by REFERENCE_PATH (as for ``gen_golden``), and exits 2 while the
variable is unset or names no checkout.

    REFERENCE_PATH=/path/to/reference \\
        python -m gym_soccer_tpu_torch.tools.gen_render_golden
"""
from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

from . import gen_golden

OUT = Path(gen_golden.GOLDEN).with_name("render_golden.json")
CASES = [
    # (state, lastaction or None)
    ((2, 2, 1, 4, 0), None),
    ((1, 2, 2, 4, 1), {"player_a": 3, "player_b": 4}),
    ((1, 6, 3, 1, 0), {"player_a": 3, "player_b": 0}),   # A scored
    ((2, 0, 3, 4, 0), {"player_a": 4, "player_b": 0}),   # A own goal
    ((1, 3, 2, 0, 1), {"player_a": 0, "player_b": 4}),   # B scored
    ((3, 3, 1, 6, 1), {"player_a": 0, "player_b": 3}),   # B own goal
    ((0, 1, 3, 5, 1), {"player_a": 1, "player_b": 2}),
]


def build(env_cls) -> list:
    """Each case's state, last action and ``render()`` output on a 5x4
    slip 0 env of ``env_cls``."""
    out = []
    env = env_cls(width=5, height=4, slip_prob=0.0)
    env.reset(seed=0)
    for state, lastaction in CASES:
        env.state = state
        env.lastaction = lastaction
        buf = io.StringIO()
        with redirect_stdout(buf):
            env.render()
        out.append({"state": list(state), "lastaction": lastaction,
                    "output": buf.getvalue()})
    return out


def main() -> int:
    root = gen_golden.reference_root()
    if root is None:
        print("gen_render_golden: set REFERENCE_PATH to a checkout of the "
              "upstream reference (a directory holding gym_soccer/); the "
              "fixture is made only by executing it", file=sys.stderr)
        return 2
    gen_golden.import_reference(root)
    from gym_soccer.envs.soccer_simultaneous_env import SoccerSimultaneousEnv
    print("wrote", gen_golden.write(build(SoccerSimultaneousEnv), OUT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
