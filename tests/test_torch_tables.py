"""The port's host tables (numpy copies) are byte-equal to the JAX
package's on the 5x4 and 11x7 boards."""
import os

import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import tables as jtables
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import tables

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BOARDS = [(5, 4, 0.2), (11, 7, 0.2), (5, 4, 0.0)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("w,h,q", BOARDS)
def test_statespace_byte_equal(w, h, q):
    ss = tables.build_statespace(EnvConfig(width=w, height=h, slip_prob=q))
    js = jtables.build_statespace(JaxConfig(width=w, height=h, slip_prob=q))
    assert ss.nS == js.nS
    for name in ("raw_to_dense", "dense_to_raw", "fields", "goal_mask_raw",
                 "goal_reward_raw", "unreachable_raw", "goal_raw",
                 "isd_probs", "isd_raw"):
        assert _same(getattr(ss, name), getattr(js, name)), name


@pytest.mark.parametrize("w,h,q", BOARDS)
def test_isd_byte_equal(w, h, q):
    probs, raws = tables.build_isd(EnvConfig(width=w, height=h, slip_prob=q))
    jprobs, jraws = jtables.build_isd(JaxConfig(width=w, height=h,
                                                slip_prob=q))
    assert _same(probs, jprobs) and _same(raws, jraws)
    # the ISD's fields decode its raw codes (4 entries on even heights)
    fs = tables.isd_fields(EnvConfig(width=w, height=h, slip_prob=q))
    assert fs.dtype == np.int32 and fs.shape == (len(raws), 5)
    assert len(raws) == (4 if h % 2 == 0 else 2)
