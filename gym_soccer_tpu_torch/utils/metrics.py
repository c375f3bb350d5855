"""Batched episode metrics: the port of gym_soccer_tpu/utils/metrics.py.

The reference reports per-episode stats with Python accumulators in main()
(soccer_simultaneous_env.py:569-613: episodes played, win counts, average
reward and steps).  Here the same aggregates are computed over whole
batched rollout chunks:

* `chunk_stats(out)` reduces a StepOut chunk ([T, B] or [B] leaves) to an
  `EpisodeStats` — reductions on the tensors' device, or cheap numpy on
  host arrays (it only uses `+`/`sum`, no backend-specific ops);
* `EpisodeStats.merge` combines chunks exactly (all fields are SUMS, so
  merging is plain addition — no weighted-mean bookkeeping to get wrong);
* the means the reference prints (`avg_reward`, `avg_steps`,
  soccer_simultaneous_env.py:598-613) are derived properties.

Consumers: envs/vector_env.SoccerVectorEnv accumulates these per step on
host, examples/train_minimax.py aggregates device chunks.
"""
from __future__ import annotations

from typing import NamedTuple


class EpisodeStats(NamedTuple):
    """Pure-sum episode aggregates.  Fields are array-likes (numpy scalars,
    0-d tensors, or Python ints/floats); goal and truncation counts are
    exclusive (a goal on the truncation step counts as a goal), so
    ``goals + truncations == episodes``."""
    episodes: object        # finished episodes
    goals: object           # episodes ending in a goal
    truncations: object     # episodes ending by the step limit only
    wins_a: object          # goals with A-perspective reward > 0
    wins_b: object
    reward_a_sum: object    # summed terminal A-perspective reward
    steps: object           # env-steps taken (every lane advances per tick)

    def merge(self, other: "EpisodeStats") -> "EpisodeStats":
        return EpisodeStats(*(a + b for a, b in zip(self, other)))

    @property
    def mean_reward_a(self) -> float:
        """Average A-perspective reward per finished episode (the
        reference's `avg_reward`, soccer_simultaneous_env.py:607)."""
        n = float(self.episodes)
        return float(self.reward_a_sum) / n if n else 0.0

    @property
    def mean_length(self) -> float:
        """Average env-steps per finished episode (`avg_steps`, :608)."""
        n = float(self.episodes)
        return float(self.steps) / n if n else 0.0

    @property
    def win_rate_a(self) -> float:
        """Share of finished episodes won by A (test_general.py:341's
        win-rate contract denominator)."""
        n = float(self.episodes)
        return float(self.wins_a) / n if n else 0.0

    @classmethod
    def zero(cls) -> "EpisodeStats":
        return cls(0, 0, 0, 0, 0, 0.0, 0)


def chunk_stats(out) -> EpisodeStats:
    """Aggregate a StepOut chunk (leaves [T, B] from core/batch.rollout, or
    [B] from a single step) into an EpisodeStats of scalar sums.

    Works identically on tensors (on their device) and numpy arrays
    (host-side accumulation in SoccerVectorEnv).
    """
    done, trunc = out.done, out.truncated
    size = done.numel() if hasattr(done, "numel") else done.size
    goal_win_a = (done & (out.reward_a > 0)).sum()
    goal_win_b = (done & (out.reward_a < 0)).sum()
    return EpisodeStats(
        episodes=(done | trunc).sum(),
        goals=done.sum(),
        truncations=(trunc & ~done).sum(),
        wins_a=goal_win_a,
        wins_b=goal_win_b,
        reward_a_sum=out.reward_a.sum(),
        steps=size,
    )
