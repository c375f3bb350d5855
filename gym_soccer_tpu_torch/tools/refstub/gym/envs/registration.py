"""Stub of gym.envs.registration (the reference's registration is commented
out, but its package __init__ imports the symbol)."""


def register(*args, **kwargs):
    pass
