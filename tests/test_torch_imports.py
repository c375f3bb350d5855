"""The port imports neither JAX nor the JAX package, builds nothing at
import, and refuses a CUDA device where there is none."""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

MODULES = ["gym_soccer_tpu_torch", "gym_soccer_tpu_torch.config",
           "gym_soccer_tpu_torch.core.rules",
           "gym_soccer_tpu_torch.core.tables",
           "gym_soccer_tpu_torch.core.batch",
           "gym_soccer_tpu_torch.core.mt19937",
           "gym_soccer_tpu_torch.core.parity",
           "gym_soccer_tpu_torch.core.multigrid",
           "gym_soccer_tpu_torch.core.threefry",
           "gym_soccer_tpu_torch.core.invariants",
           "gym_soccer_tpu_torch.ops.threefry_kernel",
           "gym_soccer_tpu_torch.ops.engine_kernel",
           "gym_soccer_tpu_torch.ops.mixed_alt_kernel",
           "gym_soccer_tpu_torch.ops.mixed_alt_variants",
           "gym_soccer_tpu_torch.envs.vector_env",
           "gym_soccer_tpu_torch.utils.metrics",
           "gym_soccer_tpu_torch.utils.profiling",
           "gym_soccer_tpu_torch.utils.checkpoint",
           "gym_soccer_tpu_torch.examples",
           "gym_soccer_tpu_torch.examples.train_minimax",
           "gym_soccer_tpu_torch.examples.demo",
           "gym_soccer_tpu_torch.ops.step_kernel",
           "gym_soccer_tpu_torch.ops.learner_kernel",
           "gym_soccer_tpu_torch.ops.iql_kernel",
           "gym_soccer_tpu_torch.ops.parity_kernel",
           "gym_soccer_tpu_torch.ops.parity_variants",
           "gym_soccer_tpu_torch.ops.rollout_codes",
           "gym_soccer_tpu_torch.ops.rollout_variants",
           "gym_soccer_tpu_torch.ops.learner_codes",
           "gym_soccer_tpu_torch.ops.learner_variants",
           "gym_soccer_tpu_torch.ops.iql_codes",
           "gym_soccer_tpu_torch.ops.iql_variants",
           "gym_soccer_tpu_torch.ops.altq_kernel",
           "gym_soccer_tpu_torch.ops.altq_codes",
           "gym_soccer_tpu_torch.ops.altq_variants",
           "gym_soccer_tpu_torch.ops.dispatch",
           "gym_soccer_tpu_torch.ops.rmplus_variants",
           "gym_soccer_tpu_torch.ops.scatter_kernel",
           "gym_soccer_tpu_torch.ops.scatter_variants",
           "gym_soccer_tpu_torch.spaces",
           "gym_soccer_tpu_torch.envs",
           "gym_soccer_tpu_torch.envs.soccer_alternating_env",
           "gym_soccer_tpu_torch.agents.learners",
           "gym_soccer_tpu_torch.agents.evaluation",
           "gym_soccer_tpu_torch.agents.planners",
           "gym_soccer_tpu_torch.interop",
           "gym_soccer_tpu_torch.native",
           "gym_soccer_tpu_torch.utils",
           "gym_soccer_tpu_torch.utils.policies",
           "gym_soccer_tpu_torch.envs.soccer_simultaneous_env",
           "gym_soccer_tpu_torch.registry",
           "gym_soccer_tpu_torch.entry",
           "gym_soccer_tpu_torch.tools",
           "gym_soccer_tpu_torch.tools.check_parity",
           "gym_soccer_tpu_torch.tools.run_reference_tests",
           "gym_soccer_tpu_torch.parallel",
           "gym_soccer_tpu_torch.parallel.mesh",
           "gym_soccer_tpu_torch.tools.demo_multihost",
           "gym_soccer_tpu_torch.tools.bench_scaling",
           "gym_soccer_tpu_torch.examples.alternating_demo",
           "gym_soccer_tpu_torch.tools.bench_all",
           "gym_soccer_tpu_torch.tools.bench_parity_kernel",
           "gym_soccer_tpu_torch.tools.gen_golden",
           "gym_soccer_tpu_torch.tools.gen_render_golden"]


@pytest.mark.parametrize("module", MODULES)
def test_port_never_imports_jax(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'gym_soccer_tpu.')) or "
            "m == 'gym_soccer_tpu')\n"
            "assert not bad, bad\n"
            "assert 'gym_soccer_tpu_torch.ops._build' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 [*(ROOT / "gym_soccer_tpu_torch").rglob("*.py"),
                  ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("source", SOURCES)
def test_no_import_of_jax_in_any_function(source):
    """No import statement of the port's sources or of chip_smoke.py, at
    top level or inside a function (parallel/ and the tools import lazily),
    names JAX or the JAX package."""
    import ast
    tree = ast.parse((ROOT / source).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gym_soccer_tpu"), \
                f"{source}:{node.lineno} imports {name}"


def test_importing_builds_nothing():
    """Importing the package, its native loader and the modules that use
    it runs no compiler and loads no library (torch and numpy, which load
    their own, are imported first): the native libraries are built at
    their first use."""
    code = ("import ctypes, subprocess, numpy, torch\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('built or loaded at import')\n"
            "subprocess.run = subprocess.Popen = ctypes.CDLL = refuse\n"
            "import gym_soccer_tpu_torch, gym_soccer_tpu_torch.native as n\n"
            "import gym_soccer_tpu_torch.core.parity\n"
            "import gym_soccer_tpu_torch.envs\n"
            "import gym_soccer_tpu_torch.tools.check_parity\n"
            "assert n._libs == {}, n._libs\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_device_without_a_card_raises():
    """No path carries on on the CPU when CUDA was asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gym_soccer_tpu_torch.config import EnvConfig
    from gym_soccer_tpu_torch.ops import step_kernel as sk
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    for fn in (sk.fused_rollout, sk.fused_journal_rollout):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(cfg, 0, 1024, 4, "cuda")
    # The rollout wrappers run on the card unless asked for the CPU; their
    # plain versions take a device always.
    mix = (cfg, EnvConfig(width=6, height=5, slip_prob=0.1))
    for fn, c in ((sk.fused_rollout, cfg), (sk.fused_journal_rollout, cfg),
                  (sk.multigrid_rollout, mix), (sk.alt_rollout, cfg)):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises((RuntimeError, AssertionError)):
            fn(c, 0, 1024, 4)
    for fn in (sk.fused_rollout_plain, sk.fused_journal_rollout_plain,
               sk.multigrid_rollout_plain, sk.alt_rollout_plain):
        param = inspect.signature(fn).parameters["device"]
        assert param.default is inspect.Parameter.empty
    from gym_soccer_tpu_torch.ops import parity_kernel as pk
    jr = pk.jointrow_raw(cfg, [0] * 761, [0] * 761)
    with pytest.raises((RuntimeError, AssertionError)):
        pk.parity_events(cfg, range(128), jr, 4, "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        pk.parity_scripted_events(cfg, range(128), [[0] * 128], 4, "cuda")
    # The trainers and the solver run on the card unless asked for the CPU.
    from gym_soccer_tpu_torch.agents import evaluation as ev
    from gym_soccer_tpu_torch.envs import soccer_alternating_env as alt
    from gym_soccer_tpu_torch.ops import altq_kernel as ak
    from gym_soccer_tpu_torch.ops import iql_kernel as ik
    from gym_soccer_tpu_torch.ops import learner_kernel as lk
    kw = dict(batch=256, n_chunks=1, chunk_len=4)
    for fn, args, extra in (
            (lk.fused_minimax_train, (cfg,), {}),
            (lk.fused_minimax_train, (mix,), {}),
            (lk.fused_minimax_train, (cfg,), {"packed": False}),
            (lk.fused_best_response_train, (cfg, [0] * 761, "player_a"),
             {"packed": False}),
            (lk.fused_best_response_train, (cfg, [0] * 761, "player_a"), {}),
            (ik.fused_iql_train, (cfg,), {}),
            (ik.fused_iql_train, (cfg,), {"packed": False}),
            (ak.fused_altq_train, (cfg,), {}),
            (ak.fused_altq_train, (cfg,), {"packed": False})):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args, **kw, **extra)
    tb = alt.build_alt_tables(cfg)
    for fn, args in (
            (alt.alt_value_iteration_torch, (tb.t_prob, tb.t_next_dense,
                                             tb.t_reward, tb.t_done,
                                             tb.turn)),
            (alt.alt_policy_rollout, (cfg, tb.raw_to_dense, tb.turn,
                                      tb.turn))):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args)
    for fn in (ev.shapley_iteration, ev.joint_tensors):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(cfg)
    # The chunk wrappers run where their tensors lie, and their inputs are
    # made on the card unless asked for the CPU.
    from gym_soccer_tpu_torch.core import multigrid as mg
    for fn, c in ((lk.init_state_fields, cfg), (lk.init_state_fields, mix),
                  (ik.init_iql_state_fields, cfg), (mg.lane_geometry, mix),
                  (ak.init_alt_state_fields, cfg)):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(c, 256)
    fields = [f.to("meta") for f in lk.init_state_fields(cfg, 256, "cpu")]
    for fn, cols in ((lk.packed_learner_chunk, 11), (lk.learner_chunk, 36),
                     (ik.iql_packed_chunk, 10), (ik.iql_chunk, 10)):
        table = torch.zeros(lk.n_codes(cfg), cols, device="meta")
        args = (0, table, fields) if cols != 10 else (0, 0, table, fields)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(cfg, *args, 256, 4)
    fields7 = [f.to("meta") for f in ak.init_alt_state_fields(cfg, 256,
                                                               "cpu")]
    for fn in (ak.altq_packed_chunk, ak.altq_chunk):
        table = torch.zeros(lk.n_codes(cfg), 10, device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(cfg, 0, 0, table, fields7, 256, 4)
