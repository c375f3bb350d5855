// Native threaded transition-table builder.
//
// Fills the exact padded tensors produced by the numpy reference path
// (gym_soccer_tpu/core/tables.py:build_tables) — byte-for-byte, including
// the fields of zero-probability padding slots — but in a single pass per
// state with no large intermediates.  The numpy path broadcasts ~40
// float64 temporaries of shape [nS, 5, 5, 9, 4] (hundreds of MB and tens
// of seconds for 11x7+ grids on small hosts); this builder is
// O(36 ints + doubles) of scratch per (state, joint action) and
// parallelizes over states.
//
// Game semantics replicated from core/rules.py:resolve_outcomes /
// next_cell / is_goal_state, which themselves cite the reference
// (gym_soccer/envs/soccer_simultaneous_env.py:296-373,
// :91-102).  Bit-exactness of the float64 entries holds because every
// probability is weight * combo_prob with weight in {0.25, 0.5, 1.0}
// (exact powers of two) and the cumulative sum is the same sequential
// left-to-right accumulation numpy's add.accumulate performs.
//
// Build: g++ -O3 -shared -fPIC -pthread tables_builder.cc -o _tables.so
// Loaded via ctypes by gym_soccer_tpu/native/__init__.py; the numpy path
// remains as fallback and as the cross-check oracle (tests/test_native.py).

#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int kActions = 5;
constexpr int kCombos = 9;
constexpr int kSlots = 4;
constexpr int kMaxT = kCombos * kSlots;  // 36

// (dcol, drow) per action: NOOP, NORTH, SOUTH, EAST, WEST
// (core/config.py MOVES; reference ACTION_INT_TO_MOVE :24-30).
constexpr int kMoveC[kActions] = {0, 0, 0, 1, -1};
constexpr int kMoveR[kActions] = {0, -1, 1, 0, 0};

// Which movement variant (0 = intended, 1/2 = the two orthogonal slips,
// in the reference's order :205-206) each combo uses per player
// (config.py COMBO_VARIANT_A/B; reference slip enumeration :209-223).
constexpr int kVarA[kCombos] = {0, 0, 0, 1, 2, 1, 1, 2, 2};
constexpr int kVarB[kCombos] = {0, 1, 2, 0, 0, 1, 2, 1, 2};

struct Geom {
  int W, H, grLo, grHi;

  bool inGoalRows(int x) const { return x >= grLo && x <= grHi; }

  int64_t encode(int xa, int ya, int xb, int yb, int p) const {
    return ((((int64_t)xa * W + ya) * H + xb) * W + yb) * 2 + p;
  }

  // Single-player kinematics (rules.py next_cell; reference :364-373).
  void nextCell(int x, int y, int mc, int mr, bool ball, int* nx,
                int* ny) const {
    int cx = x + mr;
    if (cx < 0) cx = 0;
    if (cx > H - 1) cx = H - 1;
    int nyt = y + mc;
    bool xoob = (nyt == 0) || (nyt == W - 1);
    bool goal = xoob && inGoalRows(cx) && ball;
    *nx = cx;
    *ny = (xoob && !goal) ? y : nyt;
  }

  bool isGoalState(int xa, int ya, int xb, int yb, int p) const {
    bool ga = (p == 0) && inGoalRows(xa) && (ya == 0 || ya == W - 1);
    bool gb = (p == 1) && inGoalRows(xb) && (yb == 0 || yb == W - 1);
    return ga || gb;
  }

  // Move variant v of action a: 0 intended, 1 -> (-mr, mc), 2 -> (mr, -mc).
  void moveVariant(int a, int v, int* mc, int* mr) const {
    int c = kMoveC[a], r = kMoveR[a];
    if (v == 0) {
      *mc = c;
      *mr = r;
    } else if (v == 1) {
      *mc = -r;
      *mr = c;
    } else {
      *mc = r;
      *mr = -c;
    }
  }
};

struct Outputs {
  double* prob;
  double* cum;
  int32_t* nextRaw;
  int32_t* nextDense;
  double* reward;
  uint8_t* done;
  uint8_t* mask;
  int32_t* first;
};

void buildRange(const Geom g, const double* mp, int64_t s0, int64_t s1,
                const int32_t* denseToRaw, const int32_t* rawToDense,
                const uint8_t* goalMaskRaw, const double* goalRewardRaw,
                Outputs o) {
  for (int64_t s = s0; s < s1; ++s) {
    const int64_t rawS = denseToRaw[s];
    int64_t t = rawS;
    const int p = (int)(t % 2);
    t /= 2;
    const int yb = (int)(t % g.W);
    t /= g.W;
    const int xb = (int)(t % g.H);
    t /= g.H;
    const int ya = (int)(t % g.W);
    const int xa = (int)(t / g.W);
    const bool gst = g.isGoalState(xa, ya, xb, yb, p);

    for (int aa = 0; aa < kActions; ++aa) {
      for (int ab = 0; ab < kActions; ++ab) {
        const int64_t row = (s * kActions * kActions + aa * kActions + ab);
        const int64_t base = row * kMaxT;
        double running = 0.0;
        int firstSlot = -1;

        for (int c = 0; c < kCombos; ++c) {
          int mca, mra, mcb, mrb;
          g.moveVariant(aa, kVarA[c], &mca, &mra);
          g.moveVariant(ab, kVarB[c], &mcb, &mrb);

          int nxa, nya, nxb, nyb;
          g.nextCell(xa, ya, mca, mra, p == 0, &nxa, &nya);
          g.nextCell(xb, yb, mcb, mrb, p == 1, &nxb, &nyb);

          // Collision chain, reference priority order (rules.py :296-362).
          const bool c1 =
              ((xa == xb) && (ya - yb == 1 || yb - ya == 1) && nya == yb &&
               nyb == ya) ||
              ((ya == yb) && (xa - xb == 1 || xb - xa == 1) && nxa == xb &&
               nxb == xa);
          const bool c2 = !c1 && ((nxa == xb && nya == yb && ab == 0) ||
                                  (nxb == xa && nyb == ya && aa == 0));
          const bool c3 =
              !c1 && !c2 &&
              ((xa == nxa && ya == nya && aa != 0 && nxb == xa && nyb == ya) ||
               (xb == nxb && yb == nyb && ab != 0 && nxa == xb && nya == yb));
          const bool c4 = !c1 && !c2 && !c3 && nxa == nxb && nya == nyb;
          const bool c5 = !c1 && !c2 && !c3 && !c4;

          // 4 ordered outcome slots (rules.py slot formulas; padding slots
          // carry weight 0 but their FIELDS still populate t_next_* so the
          // tensors match the numpy path byte-for-byte).
          int ra[kSlots], ca[kSlots], rb[kSlots], cb[kSlots], pz[kSlots];
          double w[kSlots];
          ra[0] = c5 ? nxa : xa;
          ca[0] = c5 ? nya : ya;
          rb[0] = (c4 || c5) ? nxb : xb;
          cb[0] = (c4 || c5) ? nyb : yb;
          pz[0] = c2 ? 1 - p : (c5 ? p : 0);
          w[0] = (c1 || c3) ? 0.5 : (c4 ? 0.25 : 1.0);
          ra[1] = xa;
          ca[1] = ya;
          rb[1] = c4 ? nxb : xb;
          cb[1] = c4 ? nyb : yb;
          pz[1] = 1;
          w[1] = c4 ? 0.25 : ((c1 || c3) ? 0.5 : 0.0);
          ra[2] = nxa;
          ca[2] = nya;
          rb[2] = xb;
          cb[2] = yb;
          pz[2] = 0;
          w[2] = c4 ? 0.25 : 0.0;
          ra[3] = nxa;
          ca[3] = nya;
          rb[3] = xb;
          cb[3] = yb;
          pz[3] = 1;
          w[3] = c4 ? 0.25 : 0.0;

          if (gst) {  // absorbing goal state: slot0 = self, weight 1 (:300)
            for (int k = 0; k < kSlots; ++k) {
              ra[k] = xa;
              ca[k] = ya;
              rb[k] = xb;
              cb[k] = yb;
              pz[k] = p;
              w[k] = (k == 0) ? 1.0 : 0.0;
            }
          }

          for (int k = 0; k < kSlots; ++k) {
            const int64_t i = base + c * kSlots + k;
            const bool m = (w[k] > 0.0) && (mp[c] != 0.0);
            const double pr = m ? w[k] * mp[c] : 0.0;
            const int64_t nraw = g.encode(ra[k], ca[k], rb[k], cb[k], pz[k]);
            const bool dn = goalMaskRaw[nraw] != 0;
            o.prob[i] = pr;
            running += pr;
            o.cum[i] = running;
            o.nextRaw[i] = (int32_t)nraw;
            o.nextDense[i] = rawToDense[nraw];
            o.reward[i] = (dn && nraw != rawS) ? goalRewardRaw[nraw] : 0.0;
            o.done[i] = dn ? 1 : 0;
            o.mask[i] = m ? 1 : 0;
            if (m && firstSlot < 0) firstSlot = c * kSlots + k;
          }
        }
        o.first[row] = firstSlot < 0 ? 0 : firstSlot;
      }
    }
  }
}

}  // namespace

extern "C" void soccer_build_tables(
    int32_t W, int32_t H, int32_t gr_lo, int32_t gr_hi, const double* mp,
    int64_t nS, const int32_t* dense_to_raw, const int32_t* raw_to_dense,
    const uint8_t* goal_mask_raw, const double* goal_reward_raw,
    double* t_prob, double* t_cum, int32_t* t_next_raw,
    int32_t* t_next_dense, double* t_reward, uint8_t* t_done,
    uint8_t* t_mask, int32_t* t_first, int32_t n_threads) {
  const Geom g{W, H, gr_lo, gr_hi};
  const Outputs o{t_prob,   t_cum,  t_next_raw, t_next_dense,
                  t_reward, t_done, t_mask,     t_first};
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > nS) n_threads = (int32_t)nS;
  if (n_threads == 1) {
    buildRange(g, mp, 0, nS, dense_to_raw, raw_to_dense, goal_mask_raw,
               goal_reward_raw, o);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int64_t chunk = (nS + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const int64_t s0 = i * chunk;
    const int64_t s1 = (s0 + chunk < nS) ? s0 + chunk : nS;
    if (s0 >= s1) break;
    ts.emplace_back(buildRange, g, mp, s0, s1, dense_to_raw, raw_to_dense,
                    goal_mask_raw, goal_reward_raw, o);
  }
  for (auto& th : ts) th.join();
}
