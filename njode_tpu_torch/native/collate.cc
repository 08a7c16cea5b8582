// Native collation kernels for the dense union-grid data path.
//
// The reference's collation is Python/pandas (NJODE/data_utils.py:278-316,
// GRU_ODE_Bayes/data_utils_gru_ode_bayes.py:235-303). In this framework the
// per-batch host work is (1) replaying the reference's clipped Euler stepping
// to build the union time grid (models.py:432-436 semantics; see
// njode_tpu_torch/data/grid.py:build_union_grid) and (2) scattering the
// ragged event lists into dense [K, B(, D)] tensors. For real-data workloads
// (climate: K=2000 steps; PhysioNet: K~3000) this runs per batch, so it is
// implemented natively; the numpy implementation in data/grid.py stays as
// the plain version (picked with grid.NATIVE = False), and the outputs are
// equal bit for bit (tests/test_torch_native.py).
//
// Built by njode_tpu_torch/native/__init__.py with g++ -O3 -shared into
// njode_tpu_torch/_build/ at first use; loaded via ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// Replicates grid.build_union_grid exactly (float64 host arithmetic).
//
// obs_times   [n_obs_times] sorted distinct observation times
// out_times   [max_steps]   absolute time at end of each step
// out_dts     [max_steps]   step sizes (0 past the end)
// out_obs_step[n_obs_times] grid step whose end time equals obs_times[i]
//                           (-1 if the observation lies beyond T)
// returns K (number of real steps), or -1 if max_steps is exceeded.
int64_t njode_build_union_grid(const double* obs_times, int64_t n_obs_times,
                               double delta_t, double T, int64_t max_steps,
                               double* out_times, double* out_dts,
                               int64_t* out_obs_step) {
  const double tol = 1e-10 * delta_t;
  int64_t k = 0;
  double current = 0.0;
  for (int64_t i = 0; i < n_obs_times; ++i) {
    out_obs_step[i] = -1;
  }
  for (int64_t i = 0; i < n_obs_times; ++i) {
    const double ot = obs_times[i];
    if (ot > T + 1e-10) break;  // reference breaks out (stock_model.py:90-91)
    if (ot <= tol) {
      // observation at t=0: leading dt=0 step (see grid.build_union_grid)
      if (k == 0) {
        if (k >= max_steps) return -1;
        out_times[k] = 0.0;
        out_dts[k] = 0.0;
        ++k;
      }
      out_obs_step[i] = 0;
      continue;
    }
    while (current < ot - tol) {
      const double d = (current < ot - delta_t) ? delta_t : (ot - current);
      current += d;
      if (k >= max_steps) return -1;
      out_times[k] = current;
      out_dts[k] = d;
      ++k;
    }
    out_obs_step[i] = k - 1;
  }
  while (current < T - tol) {
    const double d = (current < T - delta_t) ? delta_t : (T - current);
    current += d;
    if (k >= max_steps) return -1;
    out_times[k] = current;
    out_dts[k] = d;
    ++k;
  }
  for (int64_t j = k; j < max_steps; ++j) {
    out_times[j] = T;
    out_dts[j] = 0.0;
  }
  return k;
}

// Scatters the ragged event encoding into dense [K, B(, D)] tensors
// (grid.batch_from_events inner loop). out_* must be zero-initialized.
//
// obs_step [n_times]  grid step per event time (from njode_build_union_grid)
// time_ptr [n_times+1] CSR offsets into the event arrays
// obs_idx  [n_events]  batch row per event
// X, M     [n_events, D] (M may be null -> mask = 1 at observed rows)
void njode_densify_events(const int64_t* obs_step, const int64_t* time_ptr,
                          const int64_t* obs_idx, const float* X,
                          const float* M, int64_t n_times, int64_t B,
                          int64_t D, float* out_obs, float* out_X,
                          float* out_M) {
  for (int64_t i = 0; i < n_times; ++i) {
    const int64_t k = obs_step[i];
    if (k < 0) continue;
    for (int64_t e = time_ptr[i]; e < time_ptr[i + 1]; ++e) {
      const int64_t b = obs_idx[e];
      out_obs[k * B + b] = 1.0f;
      float* xd = out_X + (k * B + b) * D;
      float* md = out_M + (k * B + b) * D;
      const float* xs = X + e * D;
      if (M != nullptr) {
        const float* ms = M + e * D;
        for (int64_t d = 0; d < D; ++d) {
          md[d] = ms[d];
          xd[d] = xs[d];  // raw X; masking is applied by consumers
        }
      } else {
        for (int64_t d = 0; d < D; ++d) {
          md[d] = 1.0f;
          xd[d] = xs[d];
        }
      }
    }
  }
}

// Dense grid batch from grid-sampled paths (grid.batch_from_paths layout):
// paths [B, D, T+1] float64, observed [B, T+1] int64 ->
// obs [K, B], X [K, B, D] (masked), M [K, B, D], n_obs [B], K = T.
void njode_densify_paths(const double* paths, const int64_t* observed,
                         int64_t B, int64_t D, int64_t T1, float* out_obs,
                         float* out_X, float* out_M, float* out_nobs) {
  const int64_t K = T1 - 1;
  for (int64_t b = 0; b < B; ++b) {
    float n = 0.0f;
    for (int64_t t = 1; t < T1; ++t) {
      const int64_t k = t - 1;
      const float o = observed[b * T1 + t] ? 1.0f : 0.0f;
      n += o;
      out_obs[k * B + b] = o;
      float* xd = out_X + (k * B + b) * D;
      float* md = out_M + (k * B + b) * D;
      for (int64_t d = 0; d < D; ++d) {
        const float v = static_cast<float>(paths[(b * D + d) * T1 + t]);
        xd[d] = v * o;
        md[d] = o;
      }
    }
    out_nobs[b] = n;
  }
}

}  // extern "C"
