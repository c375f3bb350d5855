"""The parity kernel's lookup tables (ops/parity_kernel.build_lookup,
closed_tables) against the JAX package's parity tables and pattern-code
classes, and its shared-memory budget.  Tolerance 0: every entry is an
integer or a float64 compared for equality."""
import os

import numpy as np
import pytest
import torch

from gym_soccer_tpu.config import EnvConfig as JaxEnvConfig
from gym_soccer_tpu.core import parity as jparity
from gym_soccer_tpu.core import tables as jtables
from gym_soccer_tpu.ops import parity_kernel as jpk
from gym_soccer_tpu_torch.config import EnvConfig
from gym_soccer_tpu_torch.ops import parity_kernel as pk
from gym_soccer_tpu_torch.ops import parity_variants

# One torch intra-op thread in each xdist worker: the workers share the
# machine's cores, and a default-sized pool in each oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CASES = {"5x4-0.2": EnvConfig(5, 4, 0.2), "5x4-0.0": EnvConfig(5, 4, 0.0),
         "7x5-0.3": EnvConfig(7, 5, 0.3)}


def _jcfg(cfg):
    return JaxEnvConfig(cfg.width, cfg.height, cfg.slip_prob, cfg.max_steps)


def _jax_classes(cfg):
    """Class of each (dense state, row) from the JAX package: the pattern
    code of its outcome counts, by its rank in JAX's occ_codes."""
    jtb = jtables.build_tables(_jcfg(cfg))
    counts = jtb.t_mask.reshape(jtb.nS, 25, 9, 4).sum(-1)
    code = ((counts == 2) * 1 + (counts == 4) * 2) @ (3 ** np.arange(9))
    occ = list(jpk.build_pk(_jcfg(cfg)).occ_codes)
    return np.vectorize(occ.index)(code), occ.index(0), jtb


def _meta(cfg):
    jpt = jparity.parity_tables(_jcfg(cfg))
    m = jpt.meta
    return (m[..., 0], m[..., 1], np.ascontiguousarray(m[..., 2]).view(
        np.float32), np.ascontiguousarray(m[..., 3]).view(np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_tables_equal_jax(case):
    """Every (dense state, row, slot): next raw state, done flag and reward
    equal the JAX package's parity tables; every class is the class of the
    JAX pattern code; goal states take code 0's class and step to
    themselves with done set and reward 0; each live slot's key names its
    next state's row."""
    cfg = CASES[case]
    lt = pk.build_lookup(cfg)
    cls, cls0, jtb = _jax_classes(cfg)
    nxt, done, reward, prob = _meta(cfg)
    nS = jtb.nS
    f = pk.unpack_word(lt.next_word.astype(np.int64))
    assert np.array_equal(f["raw"][1:nS], nxt[1:])
    assert np.array_equal(f["done"][1:nS], done[1:])
    assert np.array_equal(f["reward"][1:nS].astype(np.float32), reward[1:])
    assert np.array_equal(lt.cls[1:nS], cls[1:])
    live = prob[1:] != 0
    assert np.array_equal(lt.key_raw[f["key"][1:nS]][live], nxt[1:][live])
    # the goal states: dense 0's representative first, then the others
    goals = np.concatenate([[0], np.arange(nS, len(lt.key_raw))])
    assert sorted(lt.key_raw[goals]) == sorted(jtb.goal_raw)
    assert lt.key_raw[0] == jtb.dense_to_raw[0]
    assert np.array_equal(lt.key_raw[1:nS], jtb.dense_to_raw[1:])
    assert (lt.cls[goals] == cls0).all()
    g = {k: v[goals] for k, v in f.items()}
    assert (g["raw"] == lt.key_raw[goals][:, None, None]).all()
    assert (g["key"] == goals[:, None, None]).all()
    assert (g["done"] == 1).all() and (g["reward"] == 0).all()
    assert np.array_equal(lt.raw_to_key[lt.key_raw],
                          np.arange(len(lt.key_raw)))
    # thresholds and the fallback slot: the first in-list slot
    P = len(jpk.build_pk(_jcfg(cfg)).occ_codes)
    assert lt.cum.shape == (P, 37) and lt.n_classes == P
    assert lt.cum[:, :36].tobytes() == pk.build_pk(cfg).cls_cum.tobytes()
    assert np.array_equal(lt.cum[cls[1:], 36].astype(np.int64),
                          jtb.t_first[1:])
    fi = pk.unpack_word(lt.isd_word.astype(np.int64))
    assert np.array_equal(fi["raw"], jtb.isd_raw)
    assert np.array_equal(lt.key_raw[fi["key"]], jtb.isd_raw)
    assert (fi["done"] == 0).all() and (fi["reward"] == 0).all()


@pytest.mark.parametrize("case", ["5x4-0.2", "7x5-0.3"])
def test_closed_tables_equal_per_raw_recomputation(case):
    """The raw-indexed closed-loop tables, for a random jr, equal the
    entries recomputed raw by raw from the JAX package's parity tables: the
    class of (state, jr[state]), each slot's next state, done flag and
    reward, and the key the class of the next state under jr; goal states
    keep code 0's class and step to themselves; the ISD words carry the
    ISD states' classes."""
    cfg = CASES[case]
    cls, cls0, jtb = _jax_classes(cfg)
    nxt, done, reward, _ = _meta(cfg)
    jr = np.random.RandomState(4).randint(0, 25, cfg.n_raw).astype(np.int32)
    got_cls, got_w, got_isd = (t.numpy().astype(np.int64) for t in
                               pk.closed_tables(pk.device_lookup(
                                   cfg, torch.device("cpu")),
                                   torch.as_tensor(jr)))
    f = pk.unpack_word(got_w)
    r2d = jtb.raw_to_dense
    goal = jtb.goal_mask_raw

    def cls_of(raw):
        return np.where(goal[raw], cls0, cls[np.maximum(r2d[raw], 0),
                                             jr[raw]])

    for r in range(cfg.n_raw):
        s = r2d[r]
        if s > 0:
            row = jr[r]
            assert got_cls[r] == cls[s, row], r
            assert np.array_equal(f["raw"][r], nxt[s, row]), r
            assert np.array_equal(f["done"][r], done[s, row]), r
            assert np.array_equal(f["reward"][r].astype(np.float32),
                                  reward[s, row]), r
            reach = r2d[nxt[s, row]] >= 0
            assert np.array_equal(f["key"][r][reach],
                                  cls_of(nxt[s, row][reach])), r
        elif goal[r]:
            assert got_cls[r] == cls0
            assert (f["raw"][r] == r).all() and (f["done"][r] == 1).all()
            assert (f["reward"][r] == 0).all()
            assert (f["key"][r] == cls0).all()
    fi = pk.unpack_word(got_isd)
    assert np.array_equal(fi["raw"], jtb.isd_raw)
    assert np.array_equal(fi["key"], cls_of(jtb.isd_raw))
    assert (fi["done"] == 0).all()


def test_pack_word_round_trips():
    raw = np.array([0, 1567, 32767, 5])
    done = np.array([0, 1, 1, 1])
    reward = np.array([0, -1, 1, 0])
    key = np.array([0, 511, 32767, 12627])
    w = pk.pack_word(raw, done, reward, key).astype(np.int32)
    f = pk.unpack_word(w.astype(np.int64))
    assert [f["raw"].tolist(), f["done"].tolist(), f["reward"].tolist(),
            f["key"].tolist()] == [raw.tolist(), done.tolist(),
                                   reward.tolist(), key.tolist()]
    # a word whose key sets bit 31 reads back through an int32 too
    assert pk.unpack_word(w)["key"].tolist() == key.tolist()


def test_shared_memory_budget():
    """64 lanes fit at 71 classes (5x4 slip 0.2); a block that does not fit
    raises naming the budget; 512 classes still leave room for 32 lanes."""
    P = pk.build_lookup(EnvConfig(5, 4, 0.2)).n_classes
    assert P == 71
    assert pk.smem_bytes(64, P) == 71 * 37 * 8 + 64 * 2496 + 16
    assert pk.smem_bytes(64, P) <= pk.SMEM_BUDGET
    assert pk.lanes_per_block(P) == 64
    assert pk.lanes_per_block(P, 80) == 80      # fits, leaves a ragged block
    assert 8192 % 80 != 0
    with pytest.raises(ValueError, match="budget is 232448 B"):
        pk.lanes_per_block(P, 96)
    with pytest.raises(ValueError, match="budget is 232448 B"):
        pk.lanes_per_block(P, 128)
    with pytest.raises(ValueError, match=r"\[1, 1024\]"):
        pk.lanes_per_block(P, 0)
    L = pk.lanes_per_block(pk.MAX_CLASSES)
    assert L >= 32 and pk.smem_bytes(L, pk.MAX_CLASSES) <= pk.SMEM_BUDGET
    assert pk.smem_bytes(L + 32, pk.MAX_CLASSES) > pk.SMEM_BUDGET
    # at 8192 lanes the default launch is at least 128 blocks on both boards
    for cfg in (EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)):
        n = pk.build_pk(cfg)
        assert -(-8192 // pk.lanes_per_block(len(n.occ_codes))) >= 128



@pytest.mark.parametrize("name", sorted(parity_variants.VARIANTS))
def test_parity_variants_patch_the_committed_kernel(name):
    """Each timed variant of the kernel (ops/parity_variants.py) applies
    its patches, each to exactly one place in the committed source, and
    changes it unless it is the kernel itself."""
    from gym_soccer_tpu_torch.ops import _build
    src = (_build.CSRC / "parity_kernel.cu").read_text()
    got = parity_variants.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    for _, new in parity_variants.VARIANTS[name]:
        assert new in got
    with pytest.raises(ValueError, match="matches 0 times"):
        parity_variants.variant_source("search-tree", "no kernel here")
