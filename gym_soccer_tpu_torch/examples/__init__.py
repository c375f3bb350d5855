"""Runnable examples: ``python -m gym_soccer_tpu_torch.examples.<name>``.

* ``train_minimax``: minimax-Q self-play at 8192 envs on the card (the
  twin of examples/train_minimax_tpu.py);
* ``demo``: the reference main()'s planners and 1000-episode evaluation
  (the twin of examples/demo.py).
"""
