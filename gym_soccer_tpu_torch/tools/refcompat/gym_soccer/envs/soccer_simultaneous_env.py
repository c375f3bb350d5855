from gym_soccer_tpu_torch.envs import SoccerSimultaneousEnv  # noqa: F401
