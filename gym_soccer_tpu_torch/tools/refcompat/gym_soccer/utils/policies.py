from gym_soccer_tpu_torch.utils.policies import (  # noqa: F401
    get_random_policy, get_stand_policy, load_policy, save_policy)
