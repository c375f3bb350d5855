"""``tools.gen_golden``'s builder run on the port's facade and planner
reproduces tests/golden/reference_golden.json: every entry exactly
(``tables_*``, ``traj_*``, both ``policy_eval_*`` and
``mt19937_streams``), and through its writer the committed file byte for
byte.  The tool itself runs the builder on the executed reference only
(tests/test_torch_tools.py holds its refusal without REFERENCE_PATH).
Most of the ~60 s is the table digests' walk over the facade's ``P``."""
import json
import os
from pathlib import Path

import pytest
import torch

from gym_soccer_tpu_torch.agents.planners import value_iteration
from gym_soccer_tpu_torch.envs import SoccerSimultaneousEnv
from gym_soccer_tpu_torch.tools import gen_golden

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / "reference_golden.json"
with open(GOLDEN) as f:
    ENTRIES = list(json.load(f))


@pytest.fixture(scope="module")
def built():
    return gen_golden.build(SoccerSimultaneousEnv, value_iteration)


@pytest.fixture(scope="module")
def gold():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ENTRIES)
def test_builder_reproduces_each_entry(built, gold, name):
    assert json.loads(json.dumps(built[name])) == gold[name]


def test_writer_reproduces_the_file_byte_for_byte(built, tmp_path):
    assert list(built) == ENTRIES
    path = gen_golden.write(built, tmp_path / "reference_golden.json")
    assert path.read_bytes() == GOLDEN.read_bytes()
    assert Path(gen_golden.GOLDEN) == GOLDEN
