// Fused shear-warp slice loop for Hopper (sm_90a).
//
// Replaces ovr_tpu/ops/swslice.py:_kernel_persist (the TPU kernel behind
// slice_composite_pallas) and _kernel (its BlockSpec variant, which
// computes the same function through the same _slice_body). The plain
// PyTorch version is ovr_tpu_torch/ops/swslice.py:slice_composite_plain.
//
// What it computes, for every fan pixel, front to back over the planes:
// z-lerp two voxel slabs, resample bilinearly into the ray fan, look the
// sample up in the merged RGBA table (two taps), opacity-correct with the
// exact plane/ray overlap 1-(1-a)^(base*dt), in modes 1/2 shade with a
// fan-space gradient (finite differences or the analytic bilinear
// derivative; the axial term from the previous computed plane) and in
// mode 2 a shadow read from the light lattice, then over-composite into
// 8 channels [r, g, b, nx, ny, nz, depth, alpha].
//
// Design. The TPU kernel resampled planes with 2-banded hat-matrix
// matmuls and gathered the transfer function through 128-lane chunks,
// because the TPU has no gather. Here each thread owns one fan pixel and
// reads its 8 taps straight from the native-dtype grid (f32, bf16, u8,
// u16; any strides, a negative axial stride walks the volume backward);
// a block of BR x BC pixels loops over the planes itself, which replaces
// the TPU's sequential grid axis, and keeps the 8 accumulators and the
// previous plane's sample in registers. The finite-difference gradient
// needs the neighbours' samples: each plane's block tile plus a one-
// sample halo (computed by the first 2*(BR+BC) threads) goes through
// shared memory. The RGBA table and the 72 scalars sit in shared memory.
// One launch per frame.
//
// Work avoidance per block: a plane is skipped when every macrocell
// under the block's voxel footprint (its extreme rows and columns, halo
// included, plus one voxel of margin; positions are monotone along rows
// and columns) has majorant <= 1.19e-7, which makes its opacity exactly
// zero. Modes >= 1 also compute the plane before each active one (its
// samples feed the axial difference). The block stops when no ray in it
// has T > 1e-4 with its box exit still ahead (__syncthreads_or).
//
// What bounds it on an H100: arithmetic. At the headline frame (1024^3
// bf16 volume, 1024 planes, 1352 x 2048 fan) the function must read the
// 2.15 GB grid once and write an 88.6 MB result, about 0.67 ms at
// 3.35 TB/s, and needs 81 (mode 0) to 178 (mode 2, FD gradient) f32
// operations per sample (itemised in chip_smoke.py) on the 5.7e8 of the
// fan's 2.84e9 samples that skipping and termination leave, 0.69 to
// 1.51 ms at 67 TFLOP/s. This first version spends most of its time on
// the per-sample 8-tap loads through L1 and the FD halo it recomputes;
// slab windows in shared memory (TMA) are the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#define BR 8   // fan rows per block
#define BC 32  // fan columns per block
#define NT (BR * BC)
#define MCELL 16
#define N_SCALARS 72
#define MAX_TAB 2048

enum : int {
  S_LO1 = 0, S_EX1, S_LO2, S_EX2, S_EW1, S_EW2, S_DW1, S_DW2, S_HALF, S_DZ,
  S_OFF, S_VLO, S_VSCALE, S_BASE, S_LAM0, S_NA, S_DLAM, S_EXA,
  S_ORTHO, S_LD1, S_LD2, S_LDA, S_K1O, S_K2O, S_INVDA, S_DZDLAM, S_NLA,
  S_W00, S_W01, S_W02, S_W10, S_W11, S_W12, S_W20, S_W21, S_W22,
  S_CLO1, S_CEX1, S_CLO2, S_CEX2, S_CLA, S_CHA, S_SMP0, S_SMPSC,
  S_GLO1, S_GEX1, S_GLO2, S_GEX2,
  S_EL0 = 48, S_GS = 64, S_DP = 65, S_DQ = 66, S_QLO = 67
};

struct Params {
  const void* grid;  // slab 0 of the traversal, element strides below
  long long sa, sr, sc;
  int na, nr, nc;
  const float* tab;  // (n_tab, 4)
  int n_tab;
  const float* scal;  // (N_SCALARS,)
  const float* pg;
  int wi;
  const float* qg;
  int hi;
  const int* k0;
  int n_slices;
  const float* lgrid;  // (la, lr, lc), mode 2
  const int* k0l;
  int la, lr, lc;
  const float* maj;  // (ma, mr, mc) or null
  int ma, mr, mc;
  int flip;  // maj and grid are storage-ordered; traversal runs backward
  int n_extra;
  int term;
  float* out;  // (8, hi, wi)
  int* block_planes;  // per-block count of composited planes, or null
};

struct bf16_t {
  unsigned short bits;
};

template <typename T>
__device__ __forceinline__ float load_voxel(const T* p);
template <>
__device__ __forceinline__ float load_voxel<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_voxel<bf16_t>(const bf16_t* p) {
  unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}
template <>
__device__ __forceinline__ float load_voxel<unsigned char>(
    const unsigned char* p) {
  return static_cast<float>(__ldg(p));
}
template <>
__device__ __forceinline__ float load_voxel<unsigned short>(
    const unsigned short* p) {
  return static_cast<float>(__ldg(p));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Slab entry/exit parameters of o + t*d vs [lo, lo+ext] (|d| < 1e-12
// counts as parallel).
__device__ __forceinline__ void axis_rng(float o, float d, float lo,
                                         float ext, float& lo_t,
                                         float& hi_t) {
  const bool small = fabsf(d) < 1e-12f;
  const float dd = small ? 1.0f : d;
  const float a = (lo - o) / dd;
  const float b = (lo + ext - o) / dd;
  lo_t = small ? (o >= lo ? -3.4e38f : 3.4e38f) : fminf(a, b);
  hi_t = small ? (o <= lo + ext ? 3.4e38f : -3.4e38f) : fmaxf(a, b);
}

// Continuous voxel row / column of fan coordinate q / p on plane lam.
__device__ __forceinline__ float vr_of(const float* sc, float q, float lam,
                                       int nr, bool ortho) {
  const float x2 = ortho ? q + sc[S_DW2] * lam : sc[S_EW2] + q * lam;
  return clampf((x2 - sc[S_LO2]) / sc[S_EX2] * (float)nr - 0.5f, 0.0f,
                (float)nr - 1.0f);
}
__device__ __forceinline__ float vc_of(const float* sc, float p, float lam,
                                       int nc, bool ortho) {
  const float x1 = ortho ? p + sc[S_DW1] * lam : sc[S_EW1] + p * lam;
  return clampf((x1 - sc[S_LO1]) / sc[S_EX1] * (float)nc - 0.5f, 0.0f,
                (float)nc - 1.0f);
}

// Bilinear sample of the z-lerped plane at (vr, vc), storage scale gs
// folded into the row weights. GRAD also returns the analytic
// derivatives along columns (g1) and rows (g2), zero on a node.
template <typename T, bool GRAD>
__device__ __forceinline__ float sample(const Params& P, const T* s0,
                                        const T* s1, float fz, float vr,
                                        float vc, float gs, float* g1,
                                        float* g2) {
  const int ir0 = (int)floorf(vr);
  const int ic0 = (int)floorf(vc);
  const float fr = vr - (float)ir0;
  const float fc = vc - (float)ic0;
  const long long r0 = ir0 * P.sr, r1 = min(ir0 + 1, P.nr - 1) * P.sr;
  const long long c0 = ic0 * P.sc, c1 = min(ic0 + 1, P.nc - 1) * P.sc;
  const float gz = 1.0f - fz;
  const float v00 = load_voxel(s0 + r0 + c0) * gz + load_voxel(s1 + r0 + c0) * fz;
  const float v01 = load_voxel(s0 + r0 + c1) * gz + load_voxel(s1 + r0 + c1) * fz;
  const float v10 = load_voxel(s0 + r1 + c0) * gz + load_voxel(s1 + r1 + c0) * fz;
  const float v11 = load_voxel(s0 + r1 + c1) * gz + load_voxel(s1 + r1 + c1) * fz;
  const float wr0 = (1.0f - fr) * gs;
  const float wr1 = fr * gs;
  const float t0 = v00 * wr0 + v10 * wr1;
  const float t1 = v01 * wr0 + v11 * wr1;
  if (GRAD) {
    *g1 = fc > 0.0f ? t1 - t0 : 0.0f;
    const float d0 = (v10 - v00) * gs;
    const float d1 = (v11 - v01) * gs;
    *g2 = fr > 0.0f ? d0 * (1.0f - fc) + d1 * fc : 0.0f;
  }
  return t0 * (1.0f - fc) + t1 * fc;
}

template <typename T, int MODE, bool FD>
__global__ void __launch_bounds__(NT) swslice_kernel(Params P) {
  extern __shared__ float4 tab[];  // (n_tab,) rgba
  __shared__ float sc[N_SCALARS];
  __shared__ float tile[BR + 2][BC + 2];  // FD samples + one-sample halo

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BC + tx;
  const int r_first = blockIdx.y * BR, c_block = blockIdx.x * BC;
  const int row = r_first + ty, col = c_block + tx;
  for (int i = tid; i < N_SCALARS; i += NT) sc[i] = P.scal[i];
  for (int i = tid; i < P.n_tab; i += NT)
    tab[i] = make_float4(P.tab[4 * i], P.tab[4 * i + 1], P.tab[4 * i + 2],
                         P.tab[4 * i + 3]);
  if (FD)
    for (int i = tid; i < (BR + 2) * (BC + 2); i += NT)
      (&tile[0][0])[i] = 0.0f;
  __syncthreads();

  const bool ortho = sc[S_ORTHO] > 0.5f;
  const bool col_ok = col < P.wi;
  const bool live = row < P.hi && col_ok;
  const float p = P.pg[min(col, P.wi - 1)];
  const float q = P.qg[min(row, P.hi - 1)];
  const float gs = sc[S_GS];

  // slice-independent ray geometry: clip-box interval and speed
  float l1, h1, l2, h2;
  axis_rng(ortho ? p : sc[S_EW1], ortho ? sc[S_DW1] : p, sc[S_CLO1],
           sc[S_CEX1], l1, h1);
  axis_rng(ortho ? q : sc[S_EW2], ortho ? sc[S_DW2] : q, sc[S_CLO2],
           sc[S_CEX2], l2, h2);
  const float l_in = fmaxf(fmaxf(fmaxf(l1, l2), sc[S_CLA]), 0.0f);
  const float exit_t = fminf(fminf(h1, h2), sc[S_CHA]);
  const float l_out = fmaxf(exit_t, l_in);
  const float speed = ortho ? 1.0f : sqrtf(p * p + q * q + 1.0f);
  // the FD path samples rows on the uniform lattice q0 + r*dq, which
  // extends past the fan for the halo rows
  const float q_smp = FD ? sc[S_QLO] + (float)row * sc[S_DQ] : q;

  // the block's extreme sample rows and columns (skipping footprint)
  const int r_last = min(r_first + BR, P.hi) - 1;
  const int c_first = FD ? max(c_block - 1, 0) : c_block;
  const int c_last = min(min(c_block + BC, P.wi) - 1 + (FD ? 1 : 0),
                         P.wi - 1);
  const float qa = FD ? sc[S_QLO] + (float)(r_first - 1) * sc[S_DQ]
                      : P.qg[r_first];
  const float qb = FD ? sc[S_QLO] + (float)(r_last + 1) * sc[S_DQ]
                      : P.qg[r_last];
  const float pa = P.pg[c_first], pb = P.pg[c_last];

  // does any macrocell under the block's footprint of plane j carry
  // opacity? (all threads call it: it ends in a barrier)
  auto block_active = [&](int j) -> bool {
    const float z = ((float)j + sc[S_OFF]) * sc[S_DZ];
    const float lam = z * sc[S_DLAM] + sc[S_LAM0];
    const float ra = vr_of(sc, qa, lam, P.nr, ortho);
    const float rb = vr_of(sc, qb, lam, P.nr, ortho);
    const float ca = vc_of(sc, pa, lam, P.nc, ortho);
    const float cb = vc_of(sc, pb, lam, P.nc, ortho);
    const int r0 = max((int)floorf(fminf(ra, rb)) - 1, 0) / MCELL;
    const int r1 = min((int)floorf(fmaxf(ra, rb)) + 2, P.nr - 1) / MCELL;
    const int c0 = max((int)floorf(fminf(ca, cb)) - 1, 0) / MCELL;
    const int c1 = min((int)floorf(fmaxf(ca, cb)) + 2, P.nc - 1) / MCELL;
    const int k = P.k0[j];
    const int sa = P.flip ? P.na - 1 - k : k;
    const int sb = P.flip ? P.na - 2 - k : k + 1;
    const int a0 = min(sa, sb) / MCELL, a1 = max(sa, sb) / MCELL;
    const int n_r = r1 - r0 + 1, n_c = c1 - c0 + 1;
    const int n = (a1 - a0 + 1) * n_r * n_c;
    int found = 0;
    for (int i = tid; i < n && !found; i += NT) {
      const int c = c0 + i % n_c, t = i / n_c;
      const int r = r0 + t % n_r, a = a0 + t / n_r;
      found = __ldg(P.maj + ((long long)a * P.mr + r) * P.mc + c) > 1.19e-7f;
    }
    return __syncthreads_or(found) != 0;
  };

  const T* grid = static_cast<const T*>(P.grid);
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float trans = 1.0f, prev = 0.0f;
  int jpos = 0;
  bool raw_next = (P.maj != nullptr && MODE >= 1) ? block_active(0) : false;

  for (int j = 0; j < P.n_slices; ++j) {
    if (P.maj != nullptr) {
      bool act;
      if (MODE == 0) {
        act = block_active(j);
      } else {
        const bool raw_j = raw_next;
        raw_next = (j + 1 < P.n_slices) ? block_active(j + 1) : false;
        act = raw_j || raw_next;
      }
      if (!act) continue;  // block-uniform
    }
    const float z_rel = ((float)j + sc[S_OFF]) * sc[S_DZ];
    const float lam = z_rel * sc[S_DLAM] + sc[S_LAM0];
    const float cax = clampf((z_rel - sc[S_SMP0]) * sc[S_SMPSC] - 0.5f, 0.0f,
                             sc[S_NA] - 1.0f);
    const float fz = cax - clampf(floorf(cax), 0.0f, sc[S_NA] - 2.0f);
    const T* s0 = grid + (long long)P.k0[j] * P.sa;
    const T* s1 = s0 + P.sa;
    const float x1 = ortho ? p + sc[S_DW1] * lam : sc[S_EW1] + p * lam;
    const float x2 = ortho ? q_smp + sc[S_DW2] * lam : sc[S_EW2] + q_smp * lam;
    const float vc = vc_of(sc, p, lam, P.nc, ortho);
    const float vr = vr_of(sc, q_smp, lam, P.nr, ortho);

    float smp = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if (FD) {
      if (col_ok)
        smp = sample<T, false>(P, s0, s1, fz, vr, vc, gs, nullptr, nullptr);
      tile[ty + 1][tx + 1] = smp;
      if (tid < 2 * (BR + BC)) {  // one halo sample
        int hr, hc, ti, tj;
        if (tid < BC) {
          hr = r_first - 1; hc = c_block + tid; ti = 0; tj = tid + 1;
        } else if (tid < 2 * BC) {
          hr = r_first + BR; hc = c_block + tid - BC; ti = BR + 1;
          tj = tid - BC + 1;
        } else if (tid < 2 * BC + BR) {
          hr = r_first + tid - 2 * BC; hc = c_block - 1;
          ti = tid - 2 * BC + 1; tj = 0;
        } else {
          hr = r_first + tid - 2 * BC - BR; hc = c_block + BC;
          ti = tid - 2 * BC - BR + 1; tj = BC + 1;
        }
        float hv = 0.0f;
        if (hc >= 0 && hc < P.wi) {
          const float hq = sc[S_QLO] + (float)hr * sc[S_DQ];
          hv = sample<T, false>(P, s0, s1, fz,
                                vr_of(sc, hq, lam, P.nr, ortho),
                                vc_of(sc, P.pg[hc], lam, P.nc, ortho), gs,
                                nullptr, nullptr);
        }
        tile[ti][tj] = hv;
      }
      __syncthreads();
      const float lamf = ortho ? 1.0f : lam;
      const float fwd = tile[ty + 1][tx + 2] - smp;
      const float bwd = smp - tile[ty + 1][tx];
      g1 = (col == 0 ? fwd : (col >= P.wi - 1 ? bwd : 0.5f * (fwd + bwd)))
           / (sc[S_DP] * lamf);
      g2 = (tile[ty + 2][tx + 1] - tile[ty][tx + 1])
           * (0.5f / (sc[S_DQ] * lamf));
    } else if (live) {
      smp = sample<T, (MODE >= 1)>(P, s0, s1, fz, vr, vc, gs, &g1, &g2);
      if (MODE >= 1) {
        g1 *= (float)P.nc / sc[S_EX1];
        g2 *= (float)P.nr / sc[S_EX2];
      }
    }

    if (live) {
      // classify: two-tap nodal lookup
      const float v = clampf((smp - sc[S_VLO]) * sc[S_VSCALE], 0.0f, 1.0f);
      const float cc = v * (float)(P.n_tab - 1);
      const float i0f = clampf(floorf(cc), 0.0f, (float)(P.n_tab - 1));
      const float f = cc - i0f;
      const int i0 = (int)i0f;
      const float4 lo = tab[i0];
      const float4 up = tab[min(i0 + 1, P.n_tab - 1)];
      float rgb[3] = {clampf(lo.x * (1.0f - f) + up.x * f, 0.0f, 1.0f),
                      clampf(lo.y * (1.0f - f) + up.y * f, 0.0f, 1.0f),
                      clampf(lo.z * (1.0f - f) + up.z * f, 0.0f, 1.0f)};
      const float a_raw = lo.w * (1.0f - f) + up.w * f;

      // opacity correction over the exact plane/ray overlap
      const float seg_lo = fmaxf(lam - sc[S_HALF], l_in);
      const float seg_hi = fminf(lam + sc[S_HALF], l_out);
      const float dt_w = fmaxf(seg_hi - seg_lo, 0.0f) * speed;
      const float kk = sc[S_BASE] * dt_w;
      const float a_c = clampf(a_raw, 0.0f, 1.0f - 1e-7f);
      float a = clampf(1.0f - expf(kk * log1pf(-a_c)), 0.0f, 1.0f);
      if (fabsf(kk - 1.0f) < 1e-7f) a = clampf(a_raw, 0.0f, 1.0f);
      if (!(dt_w > 0.0f)) a = 0.0f;
      a = fminf(a, 1.0f - 1e-6f);

      float nrm[3] = {0.0f, 0.0f, 0.0f};
      if (MODE >= 1) {
        const float ds = jpos > 0 ? (smp - prev) / sc[S_DZDLAM] : 0.0f;
        const float k1 = ortho ? sc[S_K1O] : p;
        const float k2 = ortho ? sc[S_K2O] : q;
        const float ga = (ds - g1 * k1 - g2 * k2) * sc[S_INVDA];
        const float n1 = -g1, n2 = -g2, na = -ga;
        const float inv = rsqrtf(n1 * n1 + n2 * n2 + na * na + 1e-12f);
        float total =
            fabsf(sc[S_LD1] * n1 + sc[S_LD2] * n2 + sc[S_LDA] * na) * inv;
        for (int i = 0; i < P.n_extra; ++i) {
          const float* e = sc + S_EL0 + 4 * i;
          total += 0.5f * (fabsf(e[0] * n1 + e[1] * n2 + e[2] * na) * inv)
                   * e[3];
        }
        if (MODE == 2) {
          // shadow: z-lerped lattice planes, bilinear over the global box
          const float nla = sc[S_NLA];
          const float cl = clampf(z_rel / sc[S_EXA] * nla - 0.5f, 0.0f,
                                  nla - 1.0f);
          const float fzl = cl - clampf(floorf(cl), 0.0f, nla - 2.0f);
          const float* la0 = P.lgrid + (long long)P.k0l[j] * P.lr * P.lc;
          const float* la1 = P.lgrid + (long long)min(P.k0l[j] + 1, P.la - 1)
                                           * P.lr * P.lc;
          const float lvr = clampf((x2 - sc[S_GLO2]) / sc[S_GEX2] * (float)P.lr
                                   - 0.5f, 0.0f, (float)P.lr - 1.0f);
          const float lvc = clampf((x1 - sc[S_GLO1]) / sc[S_GEX1] * (float)P.lc
                                   - 0.5f, 0.0f, (float)P.lc - 1.0f);
          const int lr0 = (int)floorf(lvr), lc0 = (int)floorf(lvc);
          const float lfr = lvr - (float)lr0, lfc = lvc - (float)lc0;
          const int o00 = lr0 * P.lc + lc0;
          const int o01 = lr0 * P.lc + min(lc0 + 1, P.lc - 1);
          const int o10 = min(lr0 + 1, P.lr - 1) * P.lc + lc0;
          const int o11 = min(lr0 + 1, P.lr - 1) * P.lc + min(lc0 + 1, P.lc - 1);
          const float gl = 1.0f - fzl;
          const float l00 = __ldg(la0 + o00) * gl + __ldg(la1 + o00) * fzl;
          const float l01 = __ldg(la0 + o01) * gl + __ldg(la1 + o01) * fzl;
          const float l10 = __ldg(la0 + o10) * gl + __ldg(la1 + o10) * fzl;
          const float l11 = __ldg(la0 + o11) * gl + __ldg(la1 + o11) * fzl;
          const float sh = (l00 * (1.0f - lfr) + l10 * lfr) * (1.0f - lfc)
                           + (l01 * (1.0f - lfr) + l11 * lfr) * lfc;
          total *= 1.0f - clampf(sh, 0.0f, 1.0f);
        }
        const float shade = 0.5f + total;
        for (int c = 0; c < 3; ++c) rgb[c] = clampf(rgb[c] * shade, 0.0f, 1.0f);
        const float nu1 = n1 * inv, nu2 = n2 * inv, nua = na * inv;
        for (int r = 0; r < 3; ++r) {
          const float* w = sc + S_W00 + 3 * r;
          nrm[r] = clampf(w[0] * nu1 + w[1] * nu2 + w[2] * nua, 0.0f, 1.0f);
        }
      }
      const float aw = trans * a;
      acc[0] += aw * rgb[0];
      acc[1] += aw * rgb[1];
      acc[2] += aw * rgb[2];
      acc[3] += aw * nrm[0];
      acc[4] += aw * nrm[1];
      acc[5] += aw * nrm[2];
      acc[6] += aw * (lam * speed);
      trans = trans * (1.0f - a);
      prev = smp;
    }
    ++jpos;
    if (P.term) {
      const int alive = live && trans > 1e-4f && exit_t > lam;
      if (!__syncthreads_or(alive)) break;  // block-uniform
    } else if (FD) {
      __syncthreads();  // the next plane rewrites the tile
    }
  }

  if (live) {
    const size_t plane = (size_t)P.hi * P.wi;
    const size_t o = (size_t)row * P.wi + col;
    for (int c = 0; c < 7; ++c) P.out[c * plane + o] = acc[c];
    P.out[7 * plane + o] = 1.0f - trans;
  }
  if (P.block_planes != nullptr && tid == 0)
    P.block_planes[blockIdx.y * gridDim.x + blockIdx.x] = jpos;
}

template <typename T>
static cudaError_t launch_typed(const Params& P, int mode, int fd,
                                cudaStream_t stream) {
  const dim3 block(BC, BR);
  const dim3 grid((P.wi + BC - 1) / BC, (P.hi + BR - 1) / BR);
  const size_t smem = (size_t)P.n_tab * sizeof(float4);
  if (mode == 0) {
    swslice_kernel<T, 0, false><<<grid, block, smem, stream>>>(P);
  } else if (mode == 1) {
    if (fd) swslice_kernel<T, 1, true><<<grid, block, smem, stream>>>(P);
    else swslice_kernel<T, 1, false><<<grid, block, smem, stream>>>(P);
  } else {
    if (fd) swslice_kernel<T, 2, true><<<grid, block, smem, stream>>>(P);
    else swslice_kernel<T, 2, false><<<grid, block, smem, stream>>>(P);
  }
  return cudaGetLastError();
}

extern "C" {

int ovr_swslice_launch(const void* grid, long long sa, long long sr,
                       long long sc, int na, int nr, int nc, int dtype,
                       const float* tab, int n_tab, const float* scal,
                       const float* pg, int wi, const float* qg, int hi,
                       const int* k0, int n_slices, const float* lgrid,
                       const int* k0l, int la, int lr, int lc,
                       const float* maj, int ma, int mr, int mc, int flip,
                       int mode, int fd, int n_extra, int term, float* out,
                       int* block_planes, void* stream) {
  if (n_tab < 1 || n_tab > MAX_TAB || mode < 0 || mode > 2 || n_extra < 0
      || n_extra > 4 || wi < 1 || hi < 1 || n_slices < 0 || na < 2)
    return (int)cudaErrorInvalidValue;
  Params P{grid, sa, sr, sc, na, nr, nc, tab, n_tab, scal, pg, wi, qg, hi,
           k0, n_slices, lgrid, k0l, la, lr, lc, maj, ma, mr, mc, flip,
           n_extra, term, out, block_planes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = launch_typed<float>(P, mode, fd, s); break;
    case 1: e = launch_typed<bf16_t>(P, mode, fd, s); break;
    case 2: e = launch_typed<unsigned char>(P, mode, fd, s); break;
    case 3: e = launch_typed<unsigned short>(P, mode, fd, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

const char* ovr_swslice_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

void ovr_swslice_block_dims(int* rows, int* cols) {
  *rows = BR;
  *cols = BC;
}

}  // extern "C"
