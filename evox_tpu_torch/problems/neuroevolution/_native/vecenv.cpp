// Native vectorized environment engine — the EnvPool analog.
//
// The reference framework's host-rollout path leans on EnvPool's C++
// batched simulator (reference src/evox/problems/neuroevolution/
// reinforcement_learning/env_pool.py:41-78 drives it through io_callback).
// This file is the evox_tpu-native equivalent: classic-control dynamics
// stepped for the whole population in C++ (optionally across a persistent
// thread pool), exposed through a flat C ABI consumed via ctypes
// (problems/neuroevolution/_native/__init__.py). Dynamics mirror the
// framework's host env (hostenv.NumpyCartPoleVec) and the pure-JAX specs
// (control/envs.py) so the three backends are cross-checkable.
//
// Semantics (EnvPool defaults): one env per individual; an env that has
// terminated or truncated freezes (state held, reward 0) until the next
// reset; `truncated` trips for every env once the step counter reaches
// max_steps.
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC -o libvecenv.so vecenv.cpp
// (driven automatically by _native/__init__.py; no external deps).
// -ffp-contract=off keeps multiply/add rounding identical to numpy's so the
// cross-backend equivalence tests hold to ~1 ulp (transcendental kernels may
// still differ in the last ulp between libm and numpy's SIMD dispatch); do
// not add -march=native or -ffast-math.

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ----------------------------------------------------------------- RNG
// splitmix64 -> uniform doubles; one independent stream per env so resets
// are reproducible regardless of thread scheduling.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next_u64() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform(double lo, double hi) {
    // 53-bit mantissa draw in [0, 1): scale by 2^-53
    double u = static_cast<double>(next_u64() >> 11) * (1.0 / 9007199254740992.0);
    return lo + u * (hi - lo);
  }
};

// ----------------------------------------------------------- env tables
// Per-env-type behavior as plain functions over a small double state
// vector: reset fills the state, step integrates one transition in double
// precision and reports (reward, terminated), observe projects the state
// to the float32 observation.

enum class EnvKind { kCartPole, kPendulum, kMountainCar, kAcrobot };

struct EnvTable {
  int state_dim, obs_dim, act_dim;
  void (*reset)(double*, Rng&);
  bool (*step)(double*, const float*, double&);  // -> terminated
  void (*observe)(const double*, float*);
  bool (*terminated)(const double*);  // state-only terminal predicate
};

// --- CartPole-v1 (mirrors hostenv.NumpyCartPoleVec incl. its 0.2095 rad
// theta limit; action = 2 logits, force sign from argmax)
void cartpole_reset(double* s, Rng& rng) {
  for (int i = 0; i < 4; ++i) s[i] = rng.uniform(-0.05, 0.05);
}
bool cartpole_terminated(const double* s) {
  return std::fabs(s[0]) > 2.4 || std::fabs(s[2]) > 0.2095;
}
bool cartpole_step(double* s, const float* a, double& reward) {
  const double gravity = 9.8, masspole = 0.05 / 0.5, total_mass = 1.1,
               polemass_length = 0.05, force_mag = 10.0, tau = 0.02,
               length = 0.5;
  double force = (a[1] > a[0]) ? force_mag : -force_mag;
  double x = s[0], x_dot = s[1], th = s[2], th_dot = s[3];
  double costh = std::cos(th), sinth = std::sin(th);
  // parenthesization mirrors the numpy formulation (0.05*th_dot**2*sin …)
  // so double-precision trajectories agree bit-for-bit with
  // hostenv.NumpyCartPoleVec
  double temp =
      (force + polemass_length * (th_dot * th_dot) * sinth) / total_mass;
  double thacc =
      (gravity * sinth - costh * temp) /
      (length * (4.0 / 3.0 - masspole * (costh * costh) / total_mass));
  double xacc = temp - polemass_length * thacc * costh / total_mass;
  s[0] = x + tau * x_dot;
  s[1] = x_dot + tau * xacc;
  s[2] = th + tau * th_dot;
  s[3] = th_dot + tau * thacc;
  reward = 1.0;
  return cartpole_terminated(s);
}
void cartpole_observe(const double* s, float* o) {
  for (int i = 0; i < 4; ++i) o[i] = static_cast<float>(s[i]);
}

// --- Pendulum-v1 (control/envs.py:76-101; never terminates)
void pendulum_reset(double* s, Rng& rng) {
  s[0] = rng.uniform(-kPi, kPi);
  s[1] = rng.uniform(-1.0, 1.0);
}
bool pendulum_terminated(const double*) { return false; }
bool pendulum_step(double* s, const float* a, double& reward) {
  const double max_speed = 8.0, max_torque = 2.0, dt = 0.05, g = 10.0;
  double th = s[0], th_dot = s[1];
  double u = std::fmin(std::fmax(static_cast<double>(a[0]), -max_torque), max_torque);
  double norm_th = std::fmod(th + kPi, 2 * kPi);
  if (norm_th < 0) norm_th += 2 * kPi;
  norm_th -= kPi;
  reward = -(norm_th * norm_th + 0.1 * th_dot * th_dot + 0.001 * u * u);
  th_dot += (3.0 * g / 2.0 * std::sin(th) + 3.0 * u) * dt;
  th_dot = std::fmin(std::fmax(th_dot, -max_speed), max_speed);
  s[0] = th + th_dot * dt;
  s[1] = th_dot;
  return false;
}
void pendulum_observe(const double* s, float* o) {
  o[0] = static_cast<float>(std::cos(s[0]));
  o[1] = static_cast<float>(std::sin(s[0]));
  o[2] = static_cast<float>(s[1]);
}

// --- MountainCarContinuous-v0 (control/envs.py:106-127)
void mountain_car_reset(double* s, Rng& rng) {
  s[0] = rng.uniform(-0.6, -0.4);
  s[1] = 0.0;
}
bool mountain_car_terminated(const double* s) { return s[0] >= 0.45; }
bool mountain_car_step(double* s, const float* a, double& reward) {
  double pos = s[0], vel = s[1];
  double force = std::fmin(std::fmax(static_cast<double>(a[0]), -1.0), 1.0);
  vel += force * 0.0015 - 0.0025 * std::cos(3.0 * pos);
  vel = std::fmin(std::fmax(vel, -0.07), 0.07);
  pos = std::fmin(std::fmax(pos + vel, -1.2), 0.6);
  if (pos <= -1.2 && vel < 0) vel = 0.0;
  s[0] = pos;
  s[1] = vel;
  bool done = mountain_car_terminated(s);
  reward = (done ? 100.0 : 0.0) - 0.1 * force * force;
  return done;
}
void mountain_car_observe(const double* s, float* o) {
  o[0] = static_cast<float>(s[0]);
  o[1] = static_cast<float>(s[1]);
}

// --- Acrobot-v1 (control/envs.py:132-179; action = 3 logits -> torque)
void acrobot_reset(double* s, Rng& rng) {
  for (int i = 0; i < 4; ++i) s[i] = rng.uniform(-0.1, 0.1);
}
bool acrobot_terminated(const double* s) {
  return -std::cos(s[0]) - std::cos(s[1] + s[0]) > 1.0;
}
bool acrobot_step(double* s, const float* a, double& reward) {
  const double dt = 0.2, g = 9.8;  // l1=l2=m1=m2=1, lc1=lc2=0.5, I1=I2=1
  int best = 0;
  if (a[1] > a[best]) best = 1;
  if (a[2] > a[best]) best = 2;
  double torque = static_cast<double>(best) - 1.0;
  double t1 = s[0], t2 = s[1], td1 = s[2], td2 = s[3];
  double cos_t2 = std::cos(t2), sin_t2 = std::sin(t2);
  double d1 = 0.25 + (1.0 + 0.25 + cos_t2) + 1.0 + 1.0;
  double d2 = (0.25 + 0.5 * cos_t2) + 1.0;
  double phi2 = 0.5 * g * std::cos(t1 + t2 - kPi / 2.0);
  double phi1 = -0.5 * td2 * td2 * sin_t2 - td2 * td1 * sin_t2 +
                1.5 * g * std::cos(t1 - kPi / 2.0) + phi2;
  double tdd2 = (torque + d2 / d1 * phi1 - 0.5 * td1 * td1 * sin_t2 - phi2) /
                (0.25 + 1.0 - d2 * d2 / d1);
  double tdd1 = -(d2 * tdd2 + phi1) / d1;
  td1 = std::fmin(std::fmax(td1 + dt * tdd1, -4 * kPi), 4 * kPi);
  td2 = std::fmin(std::fmax(td2 + dt * tdd2, -9 * kPi), 9 * kPi);
  s[0] = t1 + dt * td1;
  s[1] = t2 + dt * td2;
  s[2] = td1;
  s[3] = td2;
  bool done = acrobot_terminated(s);
  reward = done ? 0.0 : -1.0;
  return done;
}
void acrobot_observe(const double* s, float* o) {
  o[0] = static_cast<float>(std::cos(s[0]));
  o[1] = static_cast<float>(std::sin(s[0]));
  o[2] = static_cast<float>(std::cos(s[1]));
  o[3] = static_cast<float>(std::sin(s[1]));
  o[4] = static_cast<float>(s[2]);
  o[5] = static_cast<float>(s[3]);
}

const EnvTable* lookup(const std::string& name) {
  static const EnvTable cartpole{4, 4, 2, cartpole_reset, cartpole_step,
                                 cartpole_observe, cartpole_terminated};
  static const EnvTable pendulum{2, 3, 1, pendulum_reset, pendulum_step,
                                 pendulum_observe, pendulum_terminated};
  static const EnvTable mountain_car{2, 2, 1, mountain_car_reset,
                                     mountain_car_step, mountain_car_observe,
                                     mountain_car_terminated};
  static const EnvTable acrobot{4, 6, 3, acrobot_reset, acrobot_step,
                                acrobot_observe, acrobot_terminated};
  if (name == "cartpole") return &cartpole;
  if (name == "pendulum") return &pendulum;
  if (name == "mountain_car") return &mountain_car;
  if (name == "acrobot") return &acrobot;
  return nullptr;
}

// ------------------------------------------------------------ thread pool
// Persistent workers executing parallel-for chunks; created once per
// VecEnv so per-step overhead is two condition-variable round trips, not
// thread spawns. With num_threads <= 1 everything runs inline.
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), epoch_(0), pending_(0) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this, i, n] { Worker(i, n); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_start_.notify_all();
    for (auto& t : workers_) t.join();
  }
  // fn(begin, end) over [0, total) split across workers
  void ParallelFor(int total, const std::function<void(int, int)>& fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      total_ = total;
      fn_ = &fn;
      pending_ = static_cast<int>(workers_.size());
      ++epoch_;
    }
    cv_start_.notify_all();
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return pending_ == 0; });
  }

 private:
  void Worker(int rank, int n) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int, int)>* fn;
      int total;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_start_.wait(lk, [this, &seen] { return stop_ || epoch_ != seen; });
        if (stop_) return;
        seen = epoch_;
        fn = fn_;
        total = total_;
      }
      int chunk = (total + n - 1) / n;
      int lo = rank * chunk, hi = std::min(total, lo + chunk);
      if (lo < hi) (*fn)(lo, hi);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) cv_done_.notify_all();
      }
    }
  }
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_start_, cv_done_;
  bool stop_;
  uint64_t epoch_;
  int pending_, total_ = 0;
  const std::function<void(int, int)>* fn_ = nullptr;
};

// ---------------------------------------------------------------- VecEnv
struct VecEnv {
  const EnvTable* table;
  int num_envs, max_steps, t;
  std::vector<double> state;  // (num_envs, state_dim)
  std::vector<uint8_t> done;
  std::unique_ptr<ThreadPool> pool;

  VecEnv(const EnvTable* tbl, int n, int max_steps_, int num_threads)
      : table(tbl), num_envs(n), max_steps(max_steps_), t(0),
        state(static_cast<size_t>(n) * tbl->state_dim, 0.0), done(n, 0) {
    if (num_threads > 1) pool.reset(new ThreadPool(num_threads));
  }

  void For(const std::function<void(int, int)>& fn) {
    if (pool)
      pool->ParallelFor(num_envs, fn);
    else
      fn(0, num_envs);
  }

  void Reset(uint64_t seed, float* obs_out) {
    t = 0;
    For([&](int lo, int hi) {
      for (int i = lo; i < hi; ++i) {
        Rng rng(seed * 0x2545f4914f6cdd1dULL + static_cast<uint64_t>(i));
        double* s = &state[static_cast<size_t>(i) * table->state_dim];
        table->reset(s, rng);
        done[i] = 0;
        table->observe(s, obs_out + static_cast<size_t>(i) * table->obs_dim);
      }
    });
  }

  void Step(const float* actions, float* obs_out, float* reward_out,
            uint8_t* term_out, uint8_t* trunc_out) {
    ++t;
    bool truncate_now = t >= max_steps;
    For([&](int lo, int hi) {
      for (int i = lo; i < hi; ++i) {
        double* s = &state[static_cast<size_t>(i) * table->state_dim];
        bool terminated;
        double reward = 0.0;
        if (!done[i]) {
          terminated =
              table->step(s, actions + static_cast<size_t>(i) * table->act_dim,
                          reward);
        } else {
          // frozen env: state held, reward 0; the terminated flag is
          // re-derived from the stored state so a finished env keeps
          // flagging terminated=1, mirroring NumpyCartPoleVec's
          // vectorized formulation (termination predicates in classic
          // control depend only on state)
          terminated = table->terminated(s);
        }
        reward_out[i] = static_cast<float>(reward);
        term_out[i] = terminated ? 1 : 0;
        trunc_out[i] = truncate_now ? 1 : 0;
        done[i] |= (terminated || truncate_now) ? 1 : 0;
        table->observe(s, obs_out + static_cast<size_t>(i) * table->obs_dim);
      }
    });
  }
};

}  // namespace

extern "C" {

void* vecenv_create(const char* name, int num_envs, int max_steps,
                    int num_threads) {
  const EnvTable* tbl = lookup(name);
  if (tbl == nullptr || num_envs <= 0 || max_steps <= 0) return nullptr;
  return new VecEnv(tbl, num_envs, max_steps, num_threads);
}

void vecenv_destroy(void* h) { delete static_cast<VecEnv*>(h); }

int vecenv_obs_dim(void* h) { return static_cast<VecEnv*>(h)->table->obs_dim; }
int vecenv_act_dim(void* h) { return static_cast<VecEnv*>(h)->table->act_dim; }
int vecenv_state_dim(void* h) {
  return static_cast<VecEnv*>(h)->table->state_dim;
}

void vecenv_reset(void* h, uint64_t seed, float* obs_out) {
  static_cast<VecEnv*>(h)->Reset(seed, obs_out);
}

void vecenv_step(void* h, const float* actions, float* obs_out,
                 float* reward_out, uint8_t* term_out, uint8_t* trunc_out) {
  static_cast<VecEnv*>(h)->Step(actions, obs_out, reward_out, term_out,
                                trunc_out);
}

// state introspection — lets tests sync this engine with the numpy / JAX
// formulations of the same dynamics and compare trajectories exactly
void vecenv_get_state(void* h, double* out) {
  VecEnv* v = static_cast<VecEnv*>(h);
  std::memcpy(out, v->state.data(), v->state.size() * sizeof(double));
}

void vecenv_set_state(void* h, const double* in) {
  VecEnv* v = static_cast<VecEnv*>(h);
  std::memcpy(v->state.data(), in, v->state.size() * sizeof(double));
  std::fill(v->done.begin(), v->done.end(), 0);
  v->t = 0;
}

}  // extern "C"
