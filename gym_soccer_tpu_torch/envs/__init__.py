from .soccer_alternating_env import SoccerAlternatingEnv  # noqa: F401
