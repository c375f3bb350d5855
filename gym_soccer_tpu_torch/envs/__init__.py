from .soccer_simultaneous_env import SoccerSimultaneousEnv  # noqa: F401
from .soccer_alternating_env import SoccerAlternatingEnv  # noqa: F401
from .vector_env import SoccerVectorEnv  # noqa: F401
