"""The port's native host components (gym_soccer_tpu_torch.native) against
the JAX package's: the same C++ sources, MT19937 streams equal to
numpy's RandomState and to the JAX package's generator, transition tables
byte-equal to the port's numpy backend and to the JAX package's native
builder, the backend dispatch, and ``core/parity.gen_streams`` drawing the
same bits on both of its paths.  All exact."""
import os
import re

import numpy as np
import pytest
import torch

from gym_soccer_tpu import native as jnative
from gym_soccer_tpu.config import EnvConfig as JaxConfig
from gym_soccer_tpu.core import tables as jtables
from gym_soccer_tpu_torch import native
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.core import parity, tables

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TENSOR_FIELDS = ("t_prob", "t_cum", "t_next_raw", "t_next_dense",
                 "t_reward", "t_done", "t_mask", "t_first")
# tests/test_native.py's seeds and configurations, and the big board
SEEDS = np.asarray([0, 1, 2, 42, 123, 2**31 - 1, 999983], np.uint64)
CONFIGS = [(5, 4, 0.2), (5, 4, 0.0), (6, 5, 0.37), (9, 6, 1.0),
           (11, 7, 0.2)]


@pytest.mark.parametrize("name", ["tables_builder", "mt19937_stream"])
def test_sources_are_the_jax_packages(name):
    """Byte for byte, once a comment's absolute directory in front of the
    reference's ``gym_soccer/`` path is dropped (the port's copy names the
    file by its path in the reference repo)."""
    ours = native.SOURCES / f"{name}.cc"
    theirs = os.path.join(os.path.dirname(jnative.__file__), f"{name}.cc")
    with open(theirs, "rb") as f:
        want = re.sub(rb"(// \()/[\w/.-]*/(gym_soccer/)", rb"\1\2", f.read())
    assert ours.read_bytes() == want


def test_library_builds_outside_the_package():
    """Built under build/gym_soccer_tpu_torch/native/, named by the
    source's hash, never beside the source."""
    assert native.have_native() and native.have_native_tables()
    for name in ("tables_builder", "mt19937_stream"):
        path = native.library_path(name)
        assert path.exists() and path.parent == native.BUILD_DIR
        assert native.SOURCES not in path.parents
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    assert not list(native.SOURCES.glob("*.so"))


def test_streams_equal_randomstate_and_the_jax_generator():
    out = native.mt19937_streams(SEEDS, 257)
    assert out.shape == (len(SEEDS), 257) and out.dtype == np.float64
    for i, s in enumerate(SEEDS):
        ref = np.random.RandomState(int(s)).random_sample(257)
        assert np.array_equal(out[i], ref), f"seed {s}"
    theirs = jnative.mt19937_streams(SEEDS, 257)
    assert theirs is not None
    assert out.tobytes() == theirs.tobytes()
    # the thread count does not change a bit
    assert np.array_equal(native.mt19937_streams(SEEDS, 257, n_threads=1),
                          out)


@pytest.mark.parametrize("w,h,slip", CONFIGS)
def test_native_tables_byte_equal(w, h, slip):
    """The C++ builder reproduces the numpy tensors byte for byte (the
    padding slots' fields, the float64 bit patterns, -0.0 rewards), and
    the JAX package's native build of the same configuration."""
    cfg = EnvConfig(width=w, height=h, slip_prob=slip)
    ss = tables.build_statespace(cfg)
    tn = tables._build_tables_native(cfg, ss)
    tp = tables._build_tables_numpy(cfg, ss)
    jcfg = JaxConfig(width=w, height=h, slip_prob=slip)
    tj = jtables.build_tables(jcfg, backend="native")
    assert tn is not None
    for f in TENSOR_FIELDS:
        a, b, c = getattr(tn, f), getattr(tp, f), getattr(tj, f)
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
        assert a.tobytes() == b.tobytes() == c.tobytes(), \
            f"{f} differs for {w}x{h}@{slip}"
    for f in ("raw_to_dense", "dense_to_raw", "fields", "isd_probs",
              "isd_raw", "goal_raw", "unreachable_raw"):
        assert getattr(tn, f).tobytes() == getattr(tj, f).tobytes(), f


def test_build_tables_backend_dispatch(monkeypatch):
    """'numpy' and 'native' choose their builder, 'auto' and the
    GYM_SOCCER_TPU_TABLES default give the same bytes, an unknown backend
    is refused, and 'native', given or from the variable, raises where the
    library cannot be built while 'auto' falls back to numpy."""
    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    tb_np = tables.build_tables(cfg, backend="numpy")
    tb_nat = tables.build_tables(cfg, backend="native")
    monkeypatch.delenv("GYM_SOCCER_TPU_TABLES", raising=False)
    tb_auto = tables.build_tables(cfg)
    monkeypatch.setenv("GYM_SOCCER_TPU_TABLES", "numpy")
    tb_env = tables.build_tables(cfg)
    for f in TENSOR_FIELDS:
        want = getattr(tb_np, f).tobytes()
        for tb in (tb_nat, tb_auto, tb_env):
            assert getattr(tb, f).tobytes() == want, f
    monkeypatch.setenv("GYM_SOCCER_TPU_TABLES", "cuda")
    with pytest.raises(ValueError, match="unknown tables backend"):
        tables.build_tables(cfg)
    with pytest.raises(ValueError, match="unknown tables backend"):
        tables.build_tables(cfg, backend="jax")
    monkeypatch.delenv("GYM_SOCCER_TPU_TABLES")
    monkeypatch.setattr(native, "build_tables_arrays",
                        lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="native table builder"):
        tables.build_tables(cfg, backend="native")
    assert tables.build_tables(cfg).t_cum.tobytes() == tb_np.t_cum.tobytes()
    monkeypatch.setenv("GYM_SOCCER_TPU_TABLES", "native")   # a CI's choice
    with pytest.raises(RuntimeError, match="native table builder"):
        tables.build_tables(cfg)


def test_failed_build_is_remembered(monkeypatch, tmp_path):
    """A library that does not build returns None, once a process, and
    leaves no temporary file behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ("-no-such-flag",))
    monkeypatch.setattr(native, "_libs", {})
    calls = []
    real = native.build

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(native, "build", counted)
    assert native.mt19937_streams([1], 4) is None
    assert native.mt19937_streams([1], 4) is None
    assert not native.have_native()
    assert calls == ["mt19937_stream"]
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        real("mt19937_stream")


def test_gen_streams_bits_equal_on_both_paths(monkeypatch):
    seeds = [5, 9, 21, 7, 11]
    hi_n, lo_n = parity.gen_streams(seeds, 64, "cpu")
    for i, s in enumerate(seeds):
        rhi, rlo = parity.f64_bits(np.random.RandomState(s).random_sample(64))
        assert np.array_equal(hi_n[i].numpy(), rhi)
        assert np.array_equal(lo_n[i].numpy(), rlo)
    monkeypatch.setattr(native, "mt19937_streams", lambda *a, **k: None)
    hi_p, lo_p = parity.gen_streams(seeds, 64, "cpu")
    assert torch.equal(hi_n, hi_p) and torch.equal(lo_n, lo_p)
    assert hi_n.dtype == lo_n.dtype == torch.int64
