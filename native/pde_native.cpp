// pde_native — host-side native runtime for pde_solver.
//
// The accelerator owns the compute path (JAX/XLA); this library owns the
// host-side hot spots around it, replacing the roles the reference delegates
// to DOLFIN/PETSc host code:
//
//  * stencil_apply / stencil_residual: OpenMP-parallel float64 stencil
//    operator application on flat node arrays (used by the mixed-precision
//    refinement loop — the float64 residual r = b - A x at 2M DOF costs
//    ~1 s single-threaded in numpy, ~50 ms here).
//    Weight layout: [n_off][n_nodes] scalars or [n_off][n_nodes][v][v]
//    blocks; neighbor addressing is flat-index offsets (assembled weights
//    carry exact zeros wherever a flat shift would wrap across a grid row,
//    so no bounds masking beyond the array ends is needed).
//
//  * tsf_write / tsf_read_*: a simple binary codec for TimeSeriesField
//    artifacts (magic "TSF1"; little-endian header; raw float64 arrays).
//    Avoids pickle's per-object overhead for multi-GB transient outputs.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see native/build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// y[i,a] = sum_o sum_b W[o,i,a,b] * x[i + delta_o, b]
// W: n_off * n_nodes * v * v contiguous, x/y: n_nodes * v.
void stencil_apply_f64(const double* W, const int64_t* deltas, int64_t n_off,
                       int64_t vdim, const double* x, double* y,
                       int64_t n_nodes) {
  const int64_t v = vdim;
  const int64_t vv = v * v;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_nodes; ++i) {
    double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // vdim <= 8
    for (int64_t o = 0; o < n_off; ++o) {
      const int64_t j = i + deltas[o];
      if (j < 0 || j >= n_nodes) continue;
      const double* Wb = W + (o * n_nodes + i) * vv;
      const double* xb = x + j * v;
      for (int64_t a = 0; a < v; ++a) {
        double s = 0;
        for (int64_t b = 0; b < v; ++b) s += Wb[a * v + b] * xb[b];
        acc[a] += s;
      }
    }
    for (int64_t a = 0; a < v; ++a) y[i * v + a] = acc[a];
  }
}

// r = b - A x ; returns ||r||^2 (float64). scale_out gets max|r|.
double stencil_residual_f64(const double* W, const int64_t* deltas,
                            int64_t n_off, int64_t vdim, const double* x,
                            const double* b, double* r, int64_t n_nodes,
                            double* scale_out) {
  const int64_t v = vdim;
  const int64_t vv = v * v;
  double norm2 = 0.0;
  double maxabs = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : norm2) \
    reduction(max : maxabs)
  for (int64_t i = 0; i < n_nodes; ++i) {
    double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int64_t o = 0; o < n_off; ++o) {
      const int64_t j = i + deltas[o];
      if (j < 0 || j >= n_nodes) continue;
      const double* Wb = W + (o * n_nodes + i) * vv;
      const double* xb = x + j * v;
      for (int64_t a = 0; a < v; ++a) {
        double s = 0;
        for (int64_t b2 = 0; b2 < v; ++b2) s += Wb[a * v + b2] * xb[b2];
        acc[a] += s;
      }
    }
    for (int64_t a = 0; a < v; ++a) {
      const double ri = b[i * v + a] - acc[a];
      r[i * v + a] = ri;
      norm2 += ri * ri;
      const double m = ri < 0 ? -ri : ri;
      if (m > maxabs) maxabs = m;
    }
  }
  if (scale_out) *scale_out = maxabs;
  return norm2;
}

int num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// ---------------------------------------------------------------------
// TSF binary codec: [magic u32 'TSF1'][version u32][N u64][Nt u64]
//                   [dim u32][meta_len u32][meta utf8 bytes]
//                   [coords f64 N*3][times f64 Nt][values f64 Nt*N]
// ---------------------------------------------------------------------

static const uint32_t TSF_MAGIC = 0x31465354u;  // "TSF1"

int tsf_write(const char* path, const double* coords, const double* values,
              const double* times, int64_t n_points, int64_t n_times,
              int32_t dim, const char* meta_json) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t version = 1;
  const uint64_t N = (uint64_t)n_points, Nt = (uint64_t)n_times;
  const uint32_t d = (uint32_t)dim;
  const uint32_t meta_len = (uint32_t)strlen(meta_json);
  int ok = 1;
  ok &= fwrite(&TSF_MAGIC, 4, 1, f) == 1;
  ok &= fwrite(&version, 4, 1, f) == 1;
  ok &= fwrite(&N, 8, 1, f) == 1;
  ok &= fwrite(&Nt, 8, 1, f) == 1;
  ok &= fwrite(&d, 4, 1, f) == 1;
  ok &= fwrite(&meta_len, 4, 1, f) == 1;
  ok &= fwrite(meta_json, 1, meta_len, f) == meta_len;
  ok &= fwrite(coords, 8, N * 3, f) == N * 3;
  ok &= fwrite(times, 8, Nt, f) == Nt;
  ok &= fwrite(values, 8, N * Nt, f) == N * Nt;
  fclose(f);
  return ok ? 0 : -2;
}

// Reads the header; returns 0 on success and fills sizes so the caller can
// allocate, then tsf_read_payload pulls the arrays.
int tsf_read_header(const char* path, int64_t* n_points, int64_t* n_times,
                    int32_t* dim, int64_t* meta_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0, version = 0, d = 0, mlen = 0;
  uint64_t N = 0, Nt = 0;
  int ok = 1;
  ok &= fread(&magic, 4, 1, f) == 1 && magic == TSF_MAGIC;
  ok &= fread(&version, 4, 1, f) == 1;
  ok &= fread(&N, 8, 1, f) == 1;
  ok &= fread(&Nt, 8, 1, f) == 1;
  ok &= fread(&d, 4, 1, f) == 1;
  ok &= fread(&mlen, 4, 1, f) == 1;
  fclose(f);
  if (!ok) return -2;
  *n_points = (int64_t)N;
  *n_times = (int64_t)Nt;
  *dim = (int32_t)d;
  *meta_len = (int64_t)mlen;
  return 0;
}

int tsf_read_payload(const char* path, char* meta_out, int64_t meta_len,
                     double* coords, double* times, double* values,
                     int64_t n_points, int64_t n_times) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 4 + 4 + 8 + 8 + 4 + 4, SEEK_SET) != 0) {
    fclose(f);
    return -2;
  }
  int ok = 1;
  ok &= (int64_t)fread(meta_out, 1, meta_len, f) == meta_len;
  ok &= (int64_t)fread(coords, 8, n_points * 3, f) == n_points * 3;
  ok &= (int64_t)fread(times, 8, n_times, f) == n_times;
  ok &= (int64_t)fread(values, 8, n_points * n_times, f) == n_points * n_times;
  fclose(f);
  return ok ? 0 : -3;
}

}  // extern "C"
