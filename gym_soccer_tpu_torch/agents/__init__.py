"""Learners' solvers and the Markov-game evaluation tools (plain PyTorch)."""
