"""Time variants of the K1-K4 rollout kernels on a CUDA card.

Each variant is ``csrc/step_kernel.cu`` with a few text patches
(`VARIANTS`), built beside the port's own build and launched through
``step_kernel``'s launch at ``chip_smoke.py``'s timed shapes: 8192 lanes x
1024 steps of ``fused_rollout`` (K1) and ``fused_journal_rollout`` (K2) on
5x4 and 11x7, slip 0.2, each at the lanes per block listed beside it.
Design variants (the previous design, one thread doing both stages, other
producer counts, tile and ring sizes, the arithmetic walk on 5x4) must give the
committed kernel's fields, stats and journal bit for bit, and equal the
plain versions run on the CPU at 1024 lanes x 64 steps (``chip_smoke.py``
phase 6's check); they are checked so.  ``diag-`` variants break the
result on purpose to show what one stage costs (the walk without the
hashing, the hashing without the walk) and are only timed.  K4's variants
(`ALT_VARIANTS`: the previous design, the arithmetic walk on 5x4, other
lanes per block) run ``alt_rollout`` at 8192 x 1024 on both boards and are
checked against the kernel and the CPU plain version at 1024 x 64.  K3's
(`MG_VARIANTS`: the previous design, other lanes per block) run
``multigrid_rollout`` at 8192 x 1024 on ``tools/bench_all.py``'s 3-board
mixture and are checked against the kernel and the CPU plain version at
1024 x 64.

    python -m gym_soccer_tpu_torch.ops.rollout_variants

prints one line per variant and block size and exits 1 if a design
variant differs.  Each line gives two times per kernel and board, both the
median of 5 legs of at least 50 ms of back-to-back launches (CUDA events):
``call``, of the launch as ``fused_rollout`` makes it (its host work
included), and ``device``, of the same launch captured in a CUDA graph and
replayed (the kernel and the stats' memset alone); and the registers, the
card's name and its power limit.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# The committed launch of K1/K2 (`launch_rollout`'s body).
_LAUNCH = """  auto kernel = rollout_kernel<kJournal, kTable>;
  static int allowed[kMaxDevices] = {};
  if (device >= kMaxDevices || smem > allowed[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  kernel<<<blocks, a.lanes + 32 * kProducerWarps, smem, st>>>(a);
  return cudaGetLastError();"""
_LAUNCH_AT = "template <bool kJournal, bool kTable>\ncudaError_t launch_rollout"
_SMEM_CHECK = ("  const int smem = smem_bytes(lanes, table != nullptr ? n_codes : "
               "0);\n  if (smem > kSmemBudget) return "
               "(int)cudaErrorInvalidValue;\n")
# The previous design: one thread a lane, the counter words, the
# slip and the collision chain inline in its step loop.
_OLD_KERNEL = """template <bool kJournal>
__global__ void old_rollout_kernel(RolloutArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0;
  if (lane < a.B) {
    State s = a.in.f[0] != nullptr ? load_state(a.in, lane)
                                   : isd_state(a.g, lane % a.g.nI);
    for (int i = 0; i < a.n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + a.step_offset);
      const uint32_t bits0 = random_word(a.seed, step, 0u, (uint32_t)lane);
      const uint32_t bits1 = random_word(a.seed, step, 1u, (uint32_t)lane);
      const uint32_t bits2 = random_word(a.seed, step, 2u, (uint32_t)lane);
      const int aa = u16(bits0, 0) % 5;
      const int ab = u16(bits0, 1) % 5;
      bool goal, trunc;
      int r;
      transition(s, aa, ab, bits1, bits2, a.g, goal, r);
      const int raw =
          (((s.ra * a.g.W + s.ca) * a.g.H + s.rb) * a.g.W + s.cb) * 2 + s.p;
      const int idx = autoreset(s, goal, bits2, a.g, trunc);
      if constexpr (kJournal)
        a.journal[(size_t)i * (size_t)a.B + lane] =
            raw | ((aa * 5 + ab) << 16) | ((int)goal << 21) |
            ((int)trunc << 22) | ((int)(r == 1) << 23) | (idx << 24);
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    store_state(a.out, lane, s);
  }
  block_sum(a.stats, rew, goals, truncs);
}

"""
_OLD_LAUNCH = """  (void)smem; (void)device;
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  old_rollout_kernel<kJournal><<<blocks, a.lanes, 0, st>>>(a);
  return cudaGetLastError();"""
# The committed consumer walk over the ring (`walk`'s body).
_WALK = """  const int per_tile = a.lanes * kTileSteps;
  const int n_full = a.n_steps / kTileSteps;
  const uint16_t* mine = ring + l * kTileSteps;
  uint32_t cur[kTileSteps / 2], nxt[kTileSteps / 2];
  if (n_tiles > 0) {
    bar_sync(kFull, nthreads);
    load_codes(mine, cur);
    if (kStages < n_tiles) bar_arrive(kEmpty, nthreads);
  }
  for (int k = 0; k < n_full; ++k) {
    const int k1 = k + 1, st1 = k1 % kStages;
    if (k1 < n_tiles) {
      bar_sync(kFull + st1, nthreads);
      load_codes(mine + st1 * per_tile, nxt);
    }
#pragma unroll
    for (int s = 0; s < kTileSteps; ++s)
      step((cur[s / 2] >> (16 * (s & 1))) & 0xFFFFu);
    if (k1 + kStages < n_tiles) bar_arrive(kEmpty + st1, nthreads);
#pragma unroll
    for (int v = 0; v < kTileSteps / 2; ++v) cur[v] = nxt[v];
  }
  const uint16_t* last = mine + (n_full % kStages) * per_tile;
#pragma unroll 1
  for (int s = 0; s < a.n_steps - n_full * kTileSteps; ++s)
    step((uint32_t)last[s]);"""
# One role for K1/K2: each lane's thread makes its own step codes, step
# i + 1's while step i walks (no producer warps, no ring); K3 and K4 keep
# the ring's walk (and are not timed in this variant).
_SINGLE_WALK = """  if constexpr (!std::is_same<Args, RolloutArgs>::value) {
""" + _WALK + """
  } else {
  (void)ring; (void)n_tiles; (void)nthreads;
  const int t_keep = 65536 - a.g.q_int, t_half = 65536 - a.g.q_int / 2;
  const uint32_t lane = (uint32_t)(blockIdx.x * a.lanes + l);
  const uint32_t at = (uint32_t)a.step_offset;
  const int mask = a.g.nI - 1;
  auto code_at = [&](uint32_t step) {
    const uint32_t c0 = step_key(a.seed, step);
    return a.g.nI == 3 ? step_code<true>(c0, lane, t_keep, t_half, mask)
                       : step_code<false>(c0, lane, t_keep, t_half, mask);
  };
  uint32_t next = code_at(at);
#pragma unroll 2
  for (int i = 0; i < a.n_steps; ++i) {
    const uint32_t code = next;
    next = code_at(at + (uint32_t)(i + 1));
    step(code);
  }
  }"""
_PRODUCERS = "constexpr int kProducerWarps = 8;"
_TILE = "constexpr int kTileSteps = 8;"
_STAGES = "constexpr int kStages = 3;"
_STEP_CALL = "      step((cur[s / 2] >> (16 * (s & 1))) & 0xFFFFu);"
_TAIL_CALL = "    step((uint32_t)last[s]);"
_CODE_STORE = """      tile[j] = (uint16_t)code(c0, (uint32_t)(lane0 + l), l);"""
_TABLE_CHOICE = """  return (int)(table != nullptr
                   ? launch_rollout<kJournal, true>(a, device, smem, st)"""
_SMEM = "  const int smem = smem_bytes(lanes, table != nullptr ? n_codes : 0);"

# name -> ([(text in step_kernel.cu, its replacement)], lanes per block to
# time); each text must occur exactly once.
VARIANTS = {
    "kernel": ([], (64, 32)),
    "previous-design": ([(_LAUNCH_AT, _OLD_KERNEL + _LAUNCH_AT),
                         (_LAUNCH, _OLD_LAUNCH),
                         (_SMEM_CHECK, "  const int smem = 0;\n")],
                        (128, 32)),
    "single-role": ([(_PRODUCERS, "constexpr int kProducerWarps = 0;"),
                     (_WALK, _SINGLE_WALK),
                     ('#include "pipeline.cuh"',
                      '#include <type_traits>\n\n#include "pipeline.cuh"')],
                    (64, 32)),
    "arithmetic-walk": ([(_TABLE_CHOICE, _TABLE_CHOICE.replace(
        "table != nullptr\n", "false\n")), (_SMEM, _SMEM.replace(
            "table != nullptr ? n_codes : 0", "0"))], (64,)),
    "producers-4": ([(_PRODUCERS, "constexpr int kProducerWarps = 4;")],
                    (64,)),
    "producers-16": ([(_PRODUCERS, "constexpr int kProducerWarps = 16;")],
                     (64,)),
    "tile-16": ([(_TILE, "constexpr int kTileSteps = 16;")], (64,)),
    "stages-2": ([(_STAGES, "constexpr int kStages = 2;")], (64,)),
    # diagnostics: wrong results, by design
    "diag-hash-only": ([(_STEP_CALL, "      step.rew += (int)((cur[s / 2] >> "
                         "(16 * (s & 1))) & 0xFFFFu);"),
                        (_TAIL_CALL, "    step.rew += (int)last[s];")],
                       (64,)),
    "diag-walk-only": ([(_CODE_STORE, "      tile[j] = (uint16_t)(j % 100);")],
                       (64,)),
}
# K4's variants, timed through ``step_kernel._launch_alt``.  The previous
# design: one thread a tick hashing and stepping (64 blocks of 128).
_ALT_LAUNCH = """  auto kernel = alt_rollout_kernel<kTable>;
  static int allowed[kMaxDevices] = {};
  if (device >= kMaxDevices || smem > allowed[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  kernel<<<blocks, a.lanes + 32 * kProducerWarps, smem, st>>>(a);
  return cudaGetLastError();"""
_ALT_LAUNCH_AT = "template <bool kTable>\ncudaError_t launch_alt"
_OLD_ALT_KERNEL = """__global__ void old_alt_rollout_kernel(AltArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int rew = 0, goals = 0, truncs = 0;
  if (lane < a.B) {
    const bool given = a.in.f[0] != nullptr;
    State s = given ? State{a.in.f[0][lane], a.in.f[1][lane], a.in.f[2][lane],
                            a.in.f[3][lane], a.in.f[4][lane], a.in.f[6][lane]}
                    : isd_state(a.g, lane % a.g.nI);
    int turn = given ? a.in.f[5][lane] : 0;
    for (int i = 0; i < a.n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + a.step_offset);
      const uint32_t bits0 = random_word(a.seed, step, 0u, (uint32_t)lane);
      const uint32_t bits1 = random_word(a.seed, step, 1u, (uint32_t)lane);
      const uint32_t bits2 = random_word(a.seed, step, 2u, (uint32_t)lane);
      bool goal, trunc;
      int r;
      alt_transition(s, turn, u16(bits0, 0) % 5, bits1, a.g, goal, r);
      autoreset(s, goal, bits2, a.g, trunc);
      turn = (goal || trunc) ? 0 : 1 - turn;
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    a.out.f[0][lane] = s.ra; a.out.f[1][lane] = s.ca;
    a.out.f[2][lane] = s.rb; a.out.f[3][lane] = s.cb;
    a.out.f[4][lane] = s.p;  a.out.f[5][lane] = turn;
    a.out.f[6][lane] = s.t;
  }
  block_sum(a.stats, rew, goals, truncs);
}

"""
_OLD_ALT_LAUNCH = """  (void)smem; (void)device;
  const int blocks = (a.B + a.lanes - 1) / a.lanes;
  old_alt_rollout_kernel<<<blocks, a.lanes, 0, st>>>(a);
  return cudaGetLastError();"""
_ALT_CHOICE = "  return (int)(table != nullptr ? launch_alt<true>(a, device, smem, st)"
_ALT_SMEM = "  const int smem = alt_smem_bytes(lanes, table != nullptr ? n_codes : 0);"
_ALT_SMEM_CHECK = ("  const int smem = alt_smem_bytes(lanes, table != nullptr ? "
                   "n_codes : 0);\n  if (smem > kSmemBudget) return "
                   "(int)cudaErrorInvalidValue;\n")
# name -> ([(text, replacement)], lanes per block): K4's variants, timed on
# both boards; "kernel" is VARIANTS' build.
ALT_VARIANTS = {
    "kernel": ([], (64, 32, 128)),
    "alt-previous-design": ([(_ALT_LAUNCH_AT, _OLD_ALT_KERNEL + _ALT_LAUNCH_AT),
                             (_ALT_LAUNCH, _OLD_ALT_LAUNCH),
                             (_ALT_SMEM_CHECK, "  const int smem = 0;\n")],
                            (128, 32)),
    "alt-arithmetic-walk": ([(_ALT_CHOICE, _ALT_CHOICE.replace(
        "table != nullptr ?", "false ?")), (_ALT_SMEM, _ALT_SMEM.replace(
            "table != nullptr ? n_codes : 0", "0"))], (64,)),
}
# K3's variants, timed through ``step_kernel._launch_mg``.  The previous
# design: one thread a lane hashing and stepping on its LaneGame (blocks of
# 128 threads).
_MG_AT = "// K3's dynamic shared memory:"
_OLD_MG_KERNEL = """__global__ void old_mg_rollout_kernel(MgArgs a) {
  __shared__ unsigned long long part[kMaxVariants * 3];
  for (int k = threadIdx.x; k < a.n_variants * 3; k += blockDim.x) part[k] = 0;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.B) {
    int rew = 0, goals = 0, truncs = 0;
    State s = load_state(a.in, lane);
    const LaneGame g = lane_game(a.geo, lane, a.max_steps);
    for (int i = 0; i < a.n_steps; ++i) {
      const uint32_t step = (uint32_t)(i + a.step_offset);
      const uint32_t bits0 = random_word(a.seed, step, 0u, (uint32_t)lane);
      const uint32_t bits1 = random_word(a.seed, step, 1u, (uint32_t)lane);
      const uint32_t bits2 = random_word(a.seed, step, 2u, (uint32_t)lane);
      bool goal, trunc;
      int r;
      transition(s, u16(bits0, 0) % 5, u16(bits0, 1) % 5, bits1, bits2, g,
                 goal, r);
      autoreset(s, goal, bits2, g, trunc);
      rew += r;
      goals += goal;
      truncs += trunc;
    }
    store_state(a.out, lane, s);
    unsigned long long* mine = part + 3 * a.geo.f[5][lane];
    atomicAdd(mine + 0, (unsigned long long)(long long)rew);
    atomicAdd(mine + 1, (unsigned long long)(long long)goals);
    atomicAdd(mine + 2, (unsigned long long)(long long)truncs);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.n_variants * 3; k += blockDim.x)
    if (part[k]) atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + k),
                           part[k]);
}

"""
_MG_LAUNCH = """  mg_rollout_kernel<<<(B + lanes - 1) / lanes, lanes + 32 * kProducerWarps,
                      mg_smem_bytes(lanes), st>>>(a);"""
_OLD_MG_LAUNCH = """  old_mg_rollout_kernel<<<(B + 127) / 128, 128, 0, st>>>(a);"""
# name -> ([(text, replacement)], lanes per block): K3's variants; "kernel"
# is VARIANTS' build.
MG_VARIANTS = {
    "kernel": ([], (64, 32, 96, 128)),
    "mg-previous-design": ([(_MG_AT, _OLD_MG_KERNEL + _MG_AT),
                            (_MG_LAUNCH, _OLD_MG_LAUNCH)], (64,)),
}
MIX3 = ((5, 4, 0.2), (6, 5, 0.1), (8, 6, 0.3))   # tools/bench_all.py:421
B, T, SLIP = 8192, 1024, 0.2
BOARDS = ((5, 4), (11, 7))
NAMES = ("fused_rollout", "fused_journal_rollout")


def variant_source(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches (of VARIANTS or
    ALT_VARIANTS) applied; ValueError if a patched text does not occur
    exactly once."""
    for old, new in {**MG_VARIANTS, **ALT_VARIANTS, **VARIANTS}[name][0]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: its patch matches "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def _out_dir():
    """Where the variants are built, beside the headers they include."""
    from . import _build
    out_dir = _build.BUILD_DIR / "rollout_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    return out_dir


def _build_variant(name: str, out_dir):
    from . import _build
    src = out_dir / f"step_kernel-{name}.cu"
    src.write_text(variant_source(
        name, (_build.CSRC / "step_kernel.cu").read_text()))
    return _build.compile_sources([src], out_dir / f"step_kernel-{name}.so")


def _registers(log: str) -> dict:
    """{'K1 table' ...: registers} of the K1/K2 kernels in an nvcc log."""
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, re.S):
        k = re.search(r"rollout_kernelILb([01])E(?:Lb([01])E)?", m.group(1))
        if k and "mg_" not in m.group(1) and "alt_" not in m.group(1):
            label = f"K{2 if k.group(1) == '1' else 1}" + (
                "" if k.group(2) is None else
                " table" if k.group(2) == "1" else " arith")
            regs[label] = int(m.group(2))
    return regs


def _device_ms(fn) -> float:
    """ms per replay of ``fn``'s launches captured in a CUDA graph."""
    import torch

    from . import parity_variants
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return parity_variants._time(graph.replay)


def _alt_variants(built, cfgs, dev, card) -> bool:
    """Time K4's variants on both boards, each design variant checked
    against the kernel and the CPU plain version; False if one differs."""
    import ctypes

    import torch

    from . import parity_variants
    from . import step_kernel as sk
    cpu = {b: [*f, *s] for b, c in cfgs.items()
           for f, s in [sk.alt_rollout(c, 3, 1024, 64, "cpu")]}
    want, ok = {}, True
    for name, (_, lane_sizes) in ALT_VARIANTS.items():
        lib = sk.declare(ctypes.CDLL(str(built[name])))
        sk._library = lambda lib=lib: lib
        for lanes in lane_sizes:
            ms, same = {}, []
            for b, c in cfgs.items():
                def fn():
                    return sk._launch_alt(c, 1, dev, B, None, T, 0, lanes)
                out = [x.cpu() for f, s in [fn()] for x in (*f, *s)]
                if name == "kernel" and lanes == 64:
                    want[b] = out
                same.append(all(torch.equal(x, y)
                                for x, y in zip(out, want[b])))
                small = [x.cpu() for f, s in
                         [sk._launch_alt(c, 3, dev, 1024, None, 64, 0, 64)]
                         for x in (*f, *s)]
                same.append(all(torch.equal(x, y)
                                for x, y in zip(small, cpu[b])))
                ms[f"K4 {b[0]}x{b[1]}"] = (parity_variants._time(fn),
                                           _device_ms(fn))
            ok &= all(same)
            print(f"[variant] {name} (K4), {lanes} lanes per block: "
                  + ", ".join(f"{k} call {v[0]} / device {v[1]} ms"
                              for k, v in ms.items())
                  + "; " + ("bit-equal to the kernel and to the CPU plain "
                            "version" if all(same) else "DIFFERS from the "
                            "kernel or the CPU plain version")
                  + f" | {card}", flush=True)
    return ok


def _mg_variants(built, dev, card) -> bool:
    """Time K3's variants on the mixture, each design variant checked
    against the kernel and the CPU plain version; False if one differs."""
    import ctypes

    import torch

    from ..config import EnvConfig
    from . import parity_variants
    from . import step_kernel as sk
    mix = tuple(EnvConfig(*b) for b in MIX3)
    cf, cs = sk.multigrid_rollout(mix, 3, 1024, 64, "cpu")
    cpu = [*cf, cs]
    start = {b: sk._start_fields(mix, b, T, dev, None, 0) for b in (B, 1024)}
    planes = {b: sk._geo(mix, b, dev) for b in (B, 1024)}
    want, ok = None, True
    for name, (_, lane_sizes) in MG_VARIANTS.items():
        lib = sk.declare(ctypes.CDLL(str(built[name])))
        sk._library = lambda lib=lib: lib
        for lanes in lane_sizes:
            def fn(b=B, steps=T, seed=1):
                return sk._launch_mg(mix, seed, start[b], planes[b], steps, 0,
                                     lanes)
            f, st = fn()
            out = [*(x.cpu() for x in f), st.cpu()]
            if want is None:
                want = out
            f, st = fn(1024, 64, 3)
            small = [*(x.cpu() for x in f), st.cpu()]
            same = (all(torch.equal(x, y) for x, y in zip(out, want))
                    and all(torch.equal(x, y) for x, y in zip(small, cpu)))
            ok &= same
            print(f"[variant] {name} (K3), {lanes} lanes per block: mixture "
                  f"call {parity_variants._time(fn)} / device "
                  f"{_device_ms(fn)} ms; "
                  + ("bit-equal to the kernel and to the CPU plain version"
                     if same else "DIFFERS from the kernel or the CPU plain "
                     "version") + f" | {card}", flush=True)
    return ok


def main() -> int:
    import ctypes

    import torch

    from ..config import EnvConfig
    from . import parity_variants
    from . import step_kernel as sk

    if not torch.cuda.is_available():
        print("rollout_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = _out_dir()
    names = [*VARIANTS, *(n for n in (*ALT_VARIANTS, *MG_VARIANTS)
                          if n not in VARIANTS)]
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: _build_variant(n, out_dir), names)))

    dev = torch.device("cuda", 0)
    cfgs = {b: EnvConfig(width=b[0], height=b[1], slip_prob=SLIP)
            for b in BOARDS}

    def call(name, cfg, lanes, batch=B, steps=T, seed=1):
        return sk._launch_rollout(name, cfg, seed, dev, batch, None, steps, 0,
                                  lanes)

    def flat(out):
        fields, stats, journal = out
        return [*fields, *stats] + ([] if journal is None else [journal])

    cpu = {(n, b): flat(sk.fused_journal_rollout(c, 3, 1024, 64, "cpu")
                        if n == NAMES[1] else
                        (*sk.fused_rollout(c, 3, 1024, 64, "cpu"), None))
           for n in NAMES for b, c in cfgs.items()}
    committed = sk._library
    want, ok = {}, True
    try:
        ok = _mg_variants(built, dev, card)
        ok &= _alt_variants(built, cfgs, dev, card)
        for name in VARIANTS:
            path = built[name]
            lib = sk.declare(ctypes.CDLL(str(path)))
            sk._library = lambda lib=lib: lib
            regs = _registers(path.with_suffix(".log").read_text())
            diag = name.startswith("diag-")
            for lanes in VARIANTS[name][1]:
                ms, same = {}, []
                for n in NAMES:
                    for b, c in cfgs.items():
                        out = [x.cpu() for x in flat(call(n, c, lanes))]
                        if name == "kernel" and lanes == 64:
                            want[(n, b)] = out
                        same.append(all(torch.equal(x, y) for x, y in
                                        zip(out, want[(n, b)])))
                        small = flat(call(n, c, 64, 1024, 64, 3))
                        same.append(all(torch.equal(x.cpu(), y) for x, y in
                                        zip(small, cpu[(n, b)])))
                        fn = lambda: call(n, c, lanes)
                        ms[f"K{NAMES.index(n) + 1} {b[0]}x{b[1]}"] = (
                            parity_variants._time(fn), _device_ms(fn))
                if not diag and not all(same):
                    ok = False
                equal = ("diagnostic, not compared" if diag
                         else "bit-equal to the kernel and to the CPU plain "
                         "versions" if all(same) else
                         "DIFFERS from the kernel or the CPU plain versions")
                print(f"[variant] {name}, {lanes} lanes per block: "
                      + ", ".join(f"{k} call {v[0]} / device {v[1]} ms"
                                  for k, v in ms.items())
                      + f"; registers {regs}; {equal} | {card}", flush=True)
    finally:
        sk._library = committed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
