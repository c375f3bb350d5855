from gym_soccer_tpu_torch.agents.planners import (  # noqa: F401
    modified_policy_iteration, policy_eval, policy_evaluation,
    policy_improvement, policy_iteration, value_iteration)
