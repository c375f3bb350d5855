"""The operations and bytes of RM+ on 5x5 zero-sum games, from games x
iterations, and R1's share of its roofline in a traced trainer run.

One game-iteration of RM+ self-play with linear averaging, counting each
floating-point add, multiply, divide and max once (an FMA as two):
regret sums 2 x 4, normalisation 2 x 5, the payoffs M y and x M 2 x 50,
the value x . (M y) 9, the regret updates 2 x 5 x 3, the averaging
2 x 5 x 2: 177.  Once a game at the end: normalising the averages 2 x 9,
the value x M y 59: 77.  Bytes: the game's 25 float32 read once, its value
and two strategies (11 float32) written once."""
from perfbench.harness.peaks import peak

FLOPS_PER_GAME_ITER = 177
FLOPS_PER_GAME = 77
BYTES_PER_GAME = (25 + 11) * 4
KERNEL = "rmplus"


def flops(games: int, iters: int) -> int:
    return games * (FLOPS_PER_GAME_ITER * iters + FLOPS_PER_GAME)


def nbytes(games: int) -> int:
    return games * BYTES_PER_GAME


def bound_s(games: int, iters: int, flops_per_s: float,
            bytes_per_s: float) -> float:
    """The least time: the larger of the operations over the float32 peak
    and the bytes over the HBM bandwidth."""
    return max(flops(games, iters) / flops_per_s, nbytes(games) / bytes_per_s)


def share(ctx):
    """% of R1's roofline in the traced window: the in-loop solve
    (``solver_iters`` over every state's game) against the median of R1's
    launches, which are nearly all in-loop solves."""
    f, b, s = (peak(ctx, "fp32_flops_per_s"), peak(ctx, "hbm_bytes_per_s"),
               ctx.trace)
    if f is None or b is None or s is None:
        return None
    times = sorted(s.kernel_times(KERNEL))
    if not times:
        return None
    games = ctx.units[0].data["q"].shape[0]
    iters = ctx.state["recipe"]["solver_iters"]
    return 100.0 * bound_s(games, iters, f, b) / times[len(times) // 2]
