// Fused shear-warp slice loop for Hopper (sm_90a).
//
// Replaces ovr_tpu/ops/swslice.py:_kernel_persist (the TPU kernel behind
// slice_composite_pallas) and _kernel (its BlockSpec variant, which
// computes the same function through the same _slice_body), each in its
// f32 form and in its bf16=True form (template flag BF16). The plain
// PyTorch version is ovr_tpu_torch/ops/swslice.py:slice_composite_plain.
//
// What it computes, for every fan pixel, front to back over the planes:
// z-lerp two voxel slabs, resample bilinearly into the ray fan, look the
// sample up in the merged RGBA table (two taps), opacity-correct with the
// exact plane/ray overlap 1-(1-a)^(base*dt), in modes 1/2 shade with a
// fan-space gradient (finite differences or the analytic bilinear
// derivative; the axial term from the previous computed plane) and in
// mode 2 a shadow read from the light lattice, then over-composite into
// 8 channels [r, g, b, nx, ny, nz, depth, alpha]. The shading adds a
// table of extra lights (template flag LIGHTS: directional ones, then
// point lights with inverse-square falloff, any number, staged in shared
// memory beside the RGBA table); without it the variants keep the
// registers of the primary light alone.
//
// The BF16 variant rounds to bf16 (to nearest even) every operand that
// the TPU kernel's bf16 matmuls take, and sums their products in f32:
// the z-lerped plane (formed as one fma, as the JAX kernel forms it on
// the CPU), the row weights with the storage scale folded in, the row
// results, the column weights, the analytic gradient's derivative
// weights, and mode 2's lattice plane, weights and row results. A product
// of two bf16 values is exact in f32, so each two-tap sum rounds once,
// as the matmul's f32 accumulation does. The TF lookup, the FD
// differences, shading and compositing stay f32. The caller casts an f32
// grid to bf16 where the TPU kernel streams it as bf16.
//
// What bounds it. At the headline frame (1024^3 bf16 volume, 1024
// planes, 1352 x 2048 fan) the function must read the 2.15 GB grid once
// and write an 88.6 MB result (about 0.67 ms at 3.35 TB/s) and needs 81
// (mode 0) to 178 (mode 2, FD gradient) f32 operations on each of the
// ~5.4e8 samples the frame needs (itemised in chip_smoke.py): operations
// bound it, at about 1.2-1.4 ms. What keeps a kernel of this shape far
// from that is not arithmetic but latency: each sample's 8 scattered
// taps depend on the plane's position, and a block that waits at a
// barrier for its slowest warp has nothing else to issue.
//
// Design. One block of BR x BC fan pixels loops over the planes itself
// (the TPU's sequential grid axis). Each pixel thread owns two fan rows
// of one column, so it carries two independent sample-to-composite
// chains whose latencies overlap, and keeps both pixels' 8 accumulators
// and previous samples in registers. Every thread of the block runs the
// same plane loop; there is no producer or consumer role. Per active
// plane j, with j+1 and j+2 the next active planes:
//   1. issue the cp.async copies of plane j+2's slab windows, block-wide
//      (16-, 8- or 4-byte copies of contiguous, aligned window rows);
//   2. sample plane j+1: 8 taps per sample from shared memory, where its
//      windows (the voxel rows and columns the tile and its FD halo tap)
//      were staged; the FD gradient's samples, halo included, go to a
//      double-buffered tile;
//   3. classify, shade and composite plane j from the tile published at
//      the last barrier; steps 2 and 3 are independent, so the sampling's
//      shared-memory latency overlaps the shading's arithmetic;
//   4. cp.async.wait_all, then the plane's one barrier,
//      __syncthreads_or(alive): it completes plane j+2's copy, publishes
//      plane j+1's tile and takes the termination vote after plane j
//      (the block stops where the plain version stops).
// Consecutive planes mostly step one slab, so a slab window is copied to
// cover its footprint on the plane that copies it and the next one; the
// next plane reuses it (slab k0 + 1 becomes the next k0) instead of
// copying it again. Four slab buffers of CR x CC voxels hold the windows
// of two stages. A stage whose footprint does not fit them (a fan much
// coarser than the volume) or whose columns are not contiguous (a view
// along the volume's fastest axis) reads its taps from the grid instead;
// the choice is per block and plane, from geometry, the same for every
// thread. Before the loop the block computes its voxel footprint on
// every plane of the schedule (kept in shared memory for the staging)
// and tests it against the macrocells: each thread takes planes, one
// ballot per 32 planes and one barrier for all. The FD halo (the rows
// above and below the tile and the columns beside it, 80 samples) is
// spread over all four warps: each takes 20 as a third sample, so no warp
// samples more than another. Samples and shading carry no branch on
// whether a pixel lies in the fan (positions are clamped, results
// discarded), so each thread's three samples and two shading chains
// overlap. Built with -fmad=false: the arithmetic rounds as the plain
// version's does, and the two agree bit for bit.
//
// Work avoidance per block: a plane is skipped when every macrocell
// under the block's voxel footprint (its extreme rows and columns, halo
// included, plus one voxel of margin; positions are monotone along rows
// and columns) has majorant <= 1.19e-7, which makes its opacity exactly
// zero. Modes >= 1 also compute the plane before each active one (its
// samples feed the axial difference). The block stops when no ray in it
// has T > 1e-4 with its exit still ahead.
//
// Surfaces. An optional per-pixel exit map (a surface hit in ray-parameter
// units, 3.4e38 where there is none; the TPU kernels have no such input)
// is read once per pixel before the plane loop: the ray's interval ends
// at max(min(box exit, map), entry), as in the JAX package's XLA slice
// loop, and its exit in the termination test is min(box exit, map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BR 8   // fan rows per block
#define BC 32  // fan columns per block
#define WARPS (BR / 2)  // each thread: two fan rows of one column
#define NT (WARPS * 32)
#define NH (2 * (BR + BC))  // FD halo samples per plane
#define NH_WARP (NH / WARPS)  // of them per warp
#define MCELL 16
#define N_SCALARS 72
#define MAX_TAB 2048
#define NBUF 4   // slab buffers: two stages of two slabs
#define CR 24    // voxel rows a slab buffer holds
#define CC 96    // voxel columns a slab buffer holds

enum : int {
  S_LO1 = 0, S_EX1, S_LO2, S_EX2, S_EW1, S_EW2, S_DW1, S_DW2, S_HALF, S_DZ,
  S_OFF, S_VLO, S_VSCALE, S_BASE, S_LAM0, S_NA, S_DLAM, S_EXA,
  S_ORTHO, S_LD1, S_LD2, S_LDA, S_K1O, S_K2O, S_INVDA, S_DZDLAM, S_NLA,
  S_W00, S_W01, S_W02, S_W10, S_W11, S_W12, S_W20, S_W21, S_W22,
  S_CLO1, S_CEX1, S_CLO2, S_CEX2, S_CLA, S_CHA, S_SMP0, S_SMPSC,
  S_GLO1, S_GEX1, S_GLO2, S_GEX2,
  S_ZA0 = 48, S_ZSG = 49, S_GS = 64, S_DP = 65, S_DQ = 66, S_QLO = 67
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
  const float* lights;  // (n_lights, 4): n_dir directional, then points
  int n_lights, n_dir;
  const float* maj;  // (ma, mr, mc) or null
  int ma, mr, mc;
  int flip;  // maj and grid are storage-ordered; traversal runs backward
  const float* exit_map;  // (hi, wi) surface exits, or null
  int term;
  float* out;  // (8, hi, wi)
  int* block_planes;  // per-block count of composited planes, or null
  int* pixel_samples;  // (hi, wi) samples needed per pixel (counting variant)
  int* stage_counts;  // (2,) planes sampled staged / direct (counting variant)
  int copy_bytes;  // cp.async size for window rows (16, 8, 4), 0: direct only
  int n_words;  // words of per-plane bits: n_slices / 32 + 2
  int fp_off;  // byte offsets in dynamic shared memory: per-plane windows,
  int ring_off;  // slab buffers
};

struct bf16_t {
  unsigned short bits;
};

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<bf16_t>(bf16_t v) {
  return __uint_as_float(static_cast<unsigned int>(v.bits) << 16);
}
template <>
__device__ __forceinline__ float to_float<unsigned char>(unsigned char v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float to_float<unsigned short>(unsigned short v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ float load_voxel(const T* p) {
  return to_float<T>(__ldg(p));
}
template <>
__device__ __forceinline__ float load_voxel<bf16_t>(const bf16_t* p) {
  bf16_t v;
  v.bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return to_float<bf16_t>(v);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// x rounded to bf16 (to nearest, ties to even), as an f32.
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a * (1 - f) + b * f with g = 1 - f: one fma in the BF16 variant (the
// JAX kernel's form on the CPU), two products and a sum otherwise.
template <bool FMA>
__device__ __forceinline__ float zlerp(float a, float b, float g, float f) {
  return FMA ? __fmaf_rn(a, g, b * f) : a * g + b * f;
}

__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
__device__ __forceinline__ float lam_of(const float* sc, int j) {
  const float z_rel = ((float)j + sc[S_OFF]) * sc[S_DZ];
  return z_rel * sc[S_DLAM] + sc[S_LAM0];
}

// Taps straight from the grid: slab pointers and element strides.
template <typename T>
struct DirectTaps {
  const T* s0;
  const T* s1;
  long long sr, sc;
  template <bool FMA>
  __device__ __forceinline__ float v(float gz, float fz, int ir, int ic)
      const {
    const long long o = ir * sr + ic * sc;
    return zlerp<FMA>(load_voxel(s0 + o), load_voxel(s1 + o), gz, fz);
  }
};

// Taps from the two slabs' staged windows (each with its own origin).
template <typename T>
struct StagedTaps {
  const T* w0;  // window of slab k0, first voxel at (r0, c0)
  const T* w1;  // window of slab k0 + 1, first voxel at (r1, c1)
  int r0, c0, r1, c1;
  template <bool FMA>
  __device__ __forceinline__ float v(float gz, float fz, int ir, int ic)
      const {
    return zlerp<FMA>(to_float<T>(w0[(ir - r0) * CC + (ic - c0)]),
                     to_float<T>(w1[(ir - r1) * CC + (ic - c1)]), gz, fz);
  }
};

// Bilinear sample of the z-lerped plane at (vr, vc), storage scale gs
// folded into the row weights. GRAD also returns the analytic
// derivatives along columns (g1) and rows (g2), zero on a node. BF16
// rounds the operands as the TPU kernel's bf16 matmuls take them (the
// head note); its derivative weights are -/+ rb(gs) on the two taps.
template <bool GRAD, bool BF16, typename Taps>
__device__ __forceinline__ float sample(const Taps& tp, int nr, int nc,
                                        float fz, float vr, float vc,
                                        float gs, float* g1, float* g2) {
  const int ir0 = (int)floorf(vr);
  const int ic0 = (int)floorf(vc);
  const float fr = vr - (float)ir0;
  const float fc = vc - (float)ic0;
  const int ir1 = min(ir0 + 1, nr - 1), ic1 = min(ic0 + 1, nc - 1);
  const float gz = 1.0f - fz;
  const float v00 = tp.template v<BF16>(gz, fz, ir0, ic0);
  const float v01 = tp.template v<BF16>(gz, fz, ir0, ic1);
  const float v10 = tp.template v<BF16>(gz, fz, ir1, ic0);
  const float v11 = tp.template v<BF16>(gz, fz, ir1, ic1);
  if (BF16) {
    const float b00 = rb(v00), b01 = rb(v01), b10 = rb(v10), b11 = rb(v11);
    const float wr0 = rb((1.0f - fr) * gs), wr1 = rb(fr * gs);
    const float wc0 = rb(1.0f - fc), wc1 = rb(fc);
    const float t0 = rb(b00 * wr0 + b10 * wr1);
    const float t1 = rb(b01 * wr0 + b11 * wr1);
    if (GRAD) {
      *g1 = fc > 0.0f ? t1 - t0 : 0.0f;
      const float gsb = rb(gs);
      const float d0 = rb(b10 * gsb - b00 * gsb);
      const float d1 = rb(b11 * gsb - b01 * gsb);
      *g2 = fr > 0.0f ? d0 * wc0 + d1 * wc1 : 0.0f;
    }
    return t0 * wc0 + t1 * wc1;
  }
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

// Voxel rows [r_lo, r_hi] and columns [c_lo, c_hi] that the block's
// samples of the plane at lam tap (positions are monotone along fan rows
// and columns, so the extreme rows and columns bound them).
struct Footprint {
  int r_lo, r_hi, c_lo, c_hi;
};

__device__ __forceinline__ Footprint footprint(const float* sc, float lam,
                                               float qa, float qb, float pa,
                                               float pb, int nr, int nc,
                                               bool ortho) {
  const float ra = vr_of(sc, qa, lam, nr, ortho);
  const float rb = vr_of(sc, qb, lam, nr, ortho);
  const float ca = vc_of(sc, pa, lam, nc, ortho);
  const float cb = vc_of(sc, pb, lam, nc, ortho);
  Footprint f;
  f.r_lo = (int)floorf(fminf(ra, rb));
  f.r_hi = min((int)floorf(fmaxf(ra, rb)) + 1, nr - 1);
  f.c_lo = (int)floorf(fminf(ca, cb));
  f.c_hi = min((int)floorf(fmaxf(ca, cb)) + 1, nc - 1);
  return f;
}

// Resident blocks per SM that a variant's registers must allow (measured
// on the H100, PERF.md): five, except the diffuse FD variant, whose
// direct taps (views along the grid's fastest axis) need the registers of
// four.
constexpr int min_blocks(int mode, bool fd) {
  return mode == 1 && fd ? 4 : 5;
}

template <typename T, int MODE, bool FD, bool COUNT, bool BF16, bool LIGHTS>
__global__ void __launch_bounds__(NT, min_blocks(MODE, FD))
    swslice_kernel(Params P) {
  constexpr int BUF = CR * CC;  // voxels per slab buffer
  extern __shared__ __align__(16) unsigned char dyn[];
  float4* tab = reinterpret_cast<float4*>(dyn);  // (n_tab,) rgba
  float4* lts = tab + P.n_tab;  // (n_lights,) the light table
  // per plane: macrocell bits, whether its window covers the next plane
  // too, and the window (rows, aligned columns; x < 0: taps from the grid)
  unsigned* raw =
      reinterpret_cast<unsigned*>(dyn + 16 * (P.n_tab + P.n_lights));
  unsigned* cov = raw + P.n_words;
  short4* wins = reinterpret_cast<short4*>(dyn + P.fp_off);
  int* k0s = reinterpret_cast<int*>(wins + P.n_slices);  // the schedule
  T* ring = reinterpret_cast<T*>(dyn + P.ring_off);  // NBUF windows
  __shared__ float sc[N_SCALARS];
  __shared__ float tile[FD ? 2 : 1][BR + 2][BC + 2];  // FD samples + halo
  // per stage (two in flight): {buffer of slab k0, of slab k0 + 1, plane,
  // flags} and the two windows' first {row, column}; flags: 1 direct,
  // 2 / 4 slab k0 / k0 + 1 copied by this stage (not reused)
  __shared__ int4 stage_meta[2][2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = warp, tx = lane;
  const int r_first = blockIdx.y * BR, c_block = blockIdx.x * BC;
  const int col = c_block + tx;
  for (int i = tid; i < N_SCALARS; i += NT) sc[i] = P.scal[i];
  for (int i = tid; i < P.n_tab; i += NT)
    tab[i] = make_float4(P.tab[4 * i], P.tab[4 * i + 1], P.tab[4 * i + 2],
                         P.tab[4 * i + 3]);
  if (LIGHTS)
    for (int i = tid; i < P.n_lights; i += NT)
      lts[i] = make_float4(P.lights[4 * i], P.lights[4 * i + 1],
                           P.lights[4 * i + 2], P.lights[4 * i + 3]);
  if (FD)
    for (int i = tid; i < 2 * (BR + 2) * (BC + 2); i += NT)
      (&tile[0][0][0])[i] = 0.0f;
  __syncthreads();

  const int n = P.n_slices;
  const bool ortho = sc[S_ORTHO] > 0.5f;
  const bool col_ok = col < P.wi;
  const float p = P.pg[min(col, P.wi - 1)];
  const float gs = sc[S_GS];
  // the block's extreme sample rows and columns (skipping footprint and
  // slab windows): with the FD gradient the rows lie on the uniform
  // lattice q0 + r*dq, which extends past the fan for the halo rows
  const int r_last = min(r_first + BR, P.hi) - 1;
  const int c_first = FD ? max(c_block - 1, 0) : c_block;
  const int c_last = min(min(c_block + BC, P.wi) - 1 + (FD ? 1 : 0),
                         P.wi - 1);

  // ---- per plane, up front: the block's voxel footprint, the slab
  // window that holds it (with the next plane's, where that fits), and
  // the macrocell skip test (each thread takes planes; a ballot per 32) --
  const bool skip = P.maj != nullptr;
  const T* grid = static_cast<const T*>(P.grid);
  const int g_bytes = P.copy_bytes;
  const int per_chunk = max(g_bytes / (int)sizeof(T), 1);  // voxels/copy
  {
    const float qa = FD ? sc[S_QLO] + (float)(r_first - 1) * sc[S_DQ]
                        : P.qg[r_first];
    const float qb = FD ? sc[S_QLO] + (float)(r_last + 1) * sc[S_DQ]
                        : P.qg[r_last];
    const float pa = P.pg[c_first], pb = P.pg[c_last];
    for (int j0 = 0; j0 < 32 * P.n_words; j0 += NT) {
      const int j = j0 + tid;
      int found = 0, covers = 0;
      if (j < n) {
        const Footprint f = footprint(sc, lam_of(sc, j), qa, qb, pa, pb,
                                      P.nr, P.nc, ortho);
        Footprint u = f;
        if (j + 1 < n) {
          const Footprint g = footprint(sc, lam_of(sc, j + 1), qa, qb, pa,
                                        pb, P.nr, P.nc, ortho);
          u.r_lo = min(f.r_lo, g.r_lo);
          u.r_hi = max(f.r_hi, g.r_hi);
          u.c_lo = min(f.c_lo, g.c_lo);
          u.c_hi = max(f.c_hi, g.c_hi);
        }
        short4 w = make_short4(-1, -1, -1, -1);
        for (int t = 0; t < 2 && g_bytes > 0 && w.x < 0; ++t) {
          const Footprint e = t == 0 ? u : f;
          const int c0 = e.c_lo / per_chunk * per_chunk;
          const int c1 = (e.c_hi / per_chunk + 1) * per_chunk - 1;
          if (e.r_hi - e.r_lo < CR && c1 - c0 < CC) {
            w = make_short4(e.r_lo, e.r_hi, c0, c1);
            covers = t == 0 && j + 1 < n;
          }
        }
        wins[j] = w;
        const int k = P.k0[j];
        k0s[j] = k;
        if (skip) {
          const int r0 = max(f.r_lo - 1, 0) / MCELL;
          const int r1 = min(f.r_hi + 1, P.nr - 1) / MCELL;
          const int c0 = max(f.c_lo - 1, 0) / MCELL;
          const int c1 = min(f.c_hi + 1, P.nc - 1) / MCELL;
          const int s_a = P.flip ? P.na - 1 - k : k;
          const int s_b = P.flip ? P.na - 2 - k : k + 1;
          const int a0 = min(s_a, s_b) / MCELL, a1 = max(s_a, s_b) / MCELL;
          for (int a = a0; a <= a1 && !found; ++a)
            for (int r = r0; r <= r1 && !found; ++r)
              for (int c = c0; c <= c1 && !found; ++c)
                found = __ldg(P.maj + ((long long)a * P.mr + r) * P.mc + c)
                        > 1.19e-7f;
        }
      }
      const unsigned bits = __ballot_sync(0xffffffffu, found);
      const unsigned cbits = __ballot_sync(0xffffffffu, covers);
      if (lane == 0 && j0 / 32 + warp < P.n_words) {
        raw[j0 / 32 + warp] = bits;  // raw[n / 32 + 1] stays 0
        cov[j0 / 32 + warp] = cbits;
      }
    }
  }
  __syncthreads();
  // the first plane after j to composite: with skipping, one whose
  // footprint holds opacity or (modes >= 1) precedes one that does
  auto next_active = [&](int j) -> int {
    int i = j + 1;
    if (!skip) return min(i, n);
    while (i < n) {
      const int w = i >> 5;
      unsigned word = raw[w];
      if (MODE >= 1) word |= (word >> 1) | (raw[w + 1] << 31);
      word >>= (i & 31);
      if (word) return min(i + __ffs(word) - 1, n);
      i = (w + 1) << 5;
    }
    return n;
  };

  // ---- slab staging ---------------------------------------------------
  // Stage plane j into stage slot `slot`. The stage in slot `keep` (none:
  // keep < 0) holds the plane before: where it copied a slab that plane j
  // needs with a window that covers plane j too, that buffer is reused,
  // else the slab is copied into a free buffer with plane j's window.
  // Every thread computes the same plan from the per-plane windows and the
  // kept stage's record; thread 0 records it, all issue the copies. The
  // records are read after the next barrier.
  auto stage = [&](int j, int slot, int keep) {
    const short4 w = wins[j];
    int4 rec0 = make_int4(-1, -1, j, 1), rec1 = make_int4(0, 0, 0, 0);
    if (w.x >= 0) {
      int4 km0 = make_int4(-1, -1, -1, 1), km1 = make_int4(0, 0, 0, 0);
      if (keep >= 0) {
        km0 = stage_meta[keep][0];
        km1 = stage_meta[keep][1];
      }
      const bool kept = !(km0.w & 1);
      const bool next = kept && km0.z + 1 == j
                        && ((cov[km0.z >> 5] >> (km0.z & 31)) & 1);
      const int dk = next ? k0s[j] - k0s[km0.z] : -2;  // slab step
      int b[2], o_r[2], o_c[2];
      bool fresh[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // the kept stage's buffer of this slab, copied there (not reused)
        const int from = dk + s;  // 0: its slab k0, 1: its slab k0 + 1
        const bool ok = (from == 0 && (km0.w & 2))
                        || (from == 1 && (km0.w & 4));
        fresh[s] = !ok;
        if (ok) {
          b[s] = from == 0 ? km0.x : km0.y;
          o_r[s] = from == 0 ? km1.x : km1.z;
          o_c[s] = from == 0 ? km1.y : km1.w;
        } else {
          int nb = 0;
          while ((kept && (nb == km0.x || nb == km0.y))
                 || (s == 1 && nb == b[0]))
            ++nb;
          b[s] = nb;
          o_r[s] = w.x;
          o_c[s] = w.z;
        }
      }
      const int chunks = (w.w - w.z + 1) / per_chunk;
      const int total = (w.y - w.x + 1) * chunks;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (!fresh[s]) continue;
        const T* src = grid + (long long)(k0s[j] + s) * P.sa
                       + (long long)w.x * P.sr + w.z;
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(ring + b[s] * BUF));
        for (int i = tid; i < total; i += NT) {
          const int r = i / chunks, c = (i - r * chunks) * per_chunk;
          cp_async(dst + (unsigned)((r * CC + c) * sizeof(T)),
                   src + r * P.sr + c, g_bytes);
        }
      }
      rec0 = make_int4(b[0], b[1], j,
                       (fresh[0] ? 2 : 0) | (fresh[1] ? 4 : 0));
      rec1 = make_int4(o_r[0], o_c[0], o_r[1], o_c[1]);
    }
    cp_async_commit();
    if (tid == 0) {
      stage_meta[slot][0] = rec0;
      stage_meta[slot][1] = rec1;
    }
  };

  // ---- per pixel (two fan rows per pixel thread: ty and ty + 4) -------
  float q[2], l_in[2], l_out[2], exit_t[2], speed[2];
  bool live[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = r_first + ty + WARPS * u;
    live[u] = row < P.hi && col_ok;
    q[u] = P.qg[min(row, P.hi - 1)];
    // slice-independent ray geometry: clip-box interval and speed
    float l1, h1, l2, h2;
    axis_rng(ortho ? p : sc[S_EW1], ortho ? sc[S_DW1] : p, sc[S_CLO1],
             sc[S_CEX1], l1, h1);
    axis_rng(ortho ? q[u] : sc[S_EW2], ortho ? sc[S_DW2] : q[u], sc[S_CLO2],
             sc[S_CEX2], l2, h2);
    l_in[u] = fmaxf(fmaxf(fmaxf(l1, l2), sc[S_CLA]), 0.0f);
    exit_t[u] = fminf(fminf(h1, h2), sc[S_CHA]);
    if (P.exit_map != nullptr)
      exit_t[u] = fminf(exit_t[u],
                        P.exit_map[(long long)min(row, P.hi - 1) * P.wi
                                   + min(col, P.wi - 1)]);
    l_out[u] = fmaxf(exit_t[u], l_in[u]);
    speed[u] = ortho ? 1.0f : sqrtf(p * p + q[u] * q[u] + 1.0f);
  }

  float acc[2][7], trans[2] = {1.0f, 1.0f}, prev[2] = {0.0f, 0.0f};
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 7; ++c) acc[u][c] = 0.0f;
  int jpos = 0, n_need[2] = {0, 0}, n_staged = 0, n_direct = 0;
  bool last_need[2] = {false, false};

  // Sample plane jj from the stage in slot `ss` into tile slot `ss` (FD)
  // or into smp/g1/g2. Positions outside the fan are clamped to the
  // block's footprint and their samples replaced by 0 (they only feed
  // pixels outside the fan), so the samples carry no branch and their
  // taps overlap.
  auto sample_plane = [&](int jj, int ss, float* smp, float* g1,
                          float* g2) {
    const float z_rel = ((float)jj + sc[S_OFF]) * sc[S_DZ];
    const float lam = z_rel * sc[S_DLAM] + sc[S_LAM0];
    const float cax = clampf((z_rel - sc[S_SMP0]) * sc[S_SMPSC] - 0.5f, 0.0f,
                             sc[S_NA] - 1.0f);
    const float fz = cax - clampf(floorf(cax), 0.0f, sc[S_NA] - 2.0f);
    const int4 sm0 = stage_meta[ss][0];
    const bool direct = sm0.w & 1;
    n_staged += direct ? 0 : 1;
    n_direct += direct ? 1 : 0;
    DirectTaps<T> dt;
    StagedTaps<T> st;
    if (direct) {
      dt.s0 = grid + (long long)k0s[jj] * P.sa;
      dt.s1 = dt.s0 + P.sa;
      dt.sr = P.sr;
      dt.sc = P.sc;
    } else {
      const int4 sm1 = stage_meta[ss][1];
      st.w0 = ring + sm0.x * BUF;
      st.w1 = ring + sm0.y * BUF;
      st.r0 = sm1.x;
      st.c0 = sm1.y;
      st.r1 = sm1.z;
      st.c1 = sm1.w;
    }
    // FD sample at fan row hr (on the row lattice) and fan column pc
    auto fd_sample = [&](int hr, float pc) -> float {
      const float vr = vr_of(sc, sc[S_QLO] + (float)hr * sc[S_DQ], lam,
                             P.nr, ortho);
      const float vc = vc_of(sc, pc, lam, P.nc, ortho);
      return direct ? sample<false, BF16>(dt, P.nr, P.nc, fz, vr, vc, gs,
                                          nullptr, nullptr)
                    : sample<false, BF16>(st, P.nr, P.nc, fz, vr, vc, gs,
                                          nullptr, nullptr);
    };
    if (FD) {
      float* tl = &tile[ss][0][0];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = r_first + ty + WARPS * u;
        const float v = fd_sample(min(row, r_last + 1), p);
        tl[(ty + WARPS * u + 1) * (BC + 2) + tx + 1] =
            col_ok && row <= r_last + 1 ? v : 0.0f;
      }
      // the halo (rows above and below the tile, columns beside it): a
      // third sample for NH_WARP lanes of every warp
      const int i = min(warp * NH_WARP + lane, NH - 1);
      int hr, hc, ti;
      if (i < 2 * BC) {
        const bool top = i < BC;
        hr = top ? r_first - 1 : r_first + BR;
        hc = c_block + (i & (BC - 1));
        ti = (top ? 0 : BR + 1) * (BC + 2) + (i & (BC - 1)) + 1;
      } else {
        const bool left = i < 2 * BC + BR;
        const int rr = (i - 2 * BC) & (BR - 1);
        hr = r_first + rr;
        hc = left ? c_block - 1 : c_block + BC;
        ti = (rr + 1) * (BC + 2) + (left ? 0 : BC + 1);
      }
      const float v = fd_sample(min(hr, r_last + 1),
                                P.pg[min(max(hc, c_first), c_last)]);
      if (lane < NH_WARP)
        tl[ti] = hc >= 0 && hc < P.wi && hr <= r_last + 1 ? v : 0.0f;
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float vr = vr_of(sc, q[u], lam, P.nr, ortho);
        const float vc = vc_of(sc, p, lam, P.nc, ortho);
        constexpr bool G = MODE >= 1;
        smp[u] = direct ? sample<G, BF16>(dt, P.nr, P.nc, fz, vr, vc, gs,
                                          &g1[u], &g2[u])
                        : sample<G, BF16>(st, P.nr, P.nc, fz, vr, vc, gs,
                                          &g1[u], &g2[u]);
        if (MODE >= 1) {
          g1[u] *= (float)P.nc / sc[S_EX1];
          g2[u] *= (float)P.nr / sc[S_EX2];
        }
      }
    }
  };

  // The pipeline: plane j's slabs are staged two planes ahead and its
  // samples taken one plane ahead (prologue: the first two planes).
  int j = next_active(-1);
  int jn = j < n ? next_active(j) : n;
  float smp_c[2] = {0.0f, 0.0f}, g1_c[2] = {0.0f, 0.0f};
  float g2_c[2] = {0.0f, 0.0f};  // plane j's samples (without FD)
  if (j < n) {
    stage(j, 0, -1);
    __syncthreads();  // the first stage's record, for the second's reuse
    if (jn < n) {
      stage(jn, 1, 0);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    sample_plane(j, 0, smp_c, g1_c, g2_c);
    cp_async_wait_all();
    __syncthreads();
  }

  for (int it = 0; j < n; ++it) {
    const int slot = it & 1;  // plane j's stage and tile; jn's: slot ^ 1
    // 1. copy the stage of the plane after next (plane j's buffers are
    // free: its samples are taken)
    const int jnn = jn < n ? next_active(jn) : n;
    if (jnn < n) stage(jnn, slot, slot ^ 1);
    // 2. sample the next plane
    float smp_n[2] = {0.0f, 0.0f}, g1_n[2] = {0.0f, 0.0f};
    float g2_n[2] = {0.0f, 0.0f};
    if (jn < n) sample_plane(jn, slot ^ 1, smp_n, g1_n, g2_n);
    const float z_rel = ((float)j + sc[S_OFF]) * sc[S_DZ];
    const float lam = z_rel * sc[S_DLAM] + sc[S_LAM0];
    float smp[2], g1[2], g2[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      smp[u] = FD ? tile[slot][ty + WARPS * u + 1][tx + 1] : smp_c[u];
      g1[u] = g1_c[u];
      g2[u] = g2_c[u];
    }

    // 3. classify, shade, composite plane j
    int alive = 0;  // a ray of the block still to composite
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // computed for every pixel slot (no branch, so the two chains
      // overlap); only live pixels keep the result
      const int tr = ty + WARPS * u;  // tile row
      const float x1 = ortho ? p + sc[S_DW1] * lam : sc[S_EW1] + p * lam;
      const float q_smp = FD ? sc[S_QLO] + (float)(r_first + tr) * sc[S_DQ]
                             : q[u];
      const float x2 = ortho ? q_smp + sc[S_DW2] * lam
                             : sc[S_EW2] + q_smp * lam;
      if (FD && MODE >= 1) {
        const float lamf = ortho ? 1.0f : lam;
        const float fwd = tile[slot][tr + 1][tx + 2] - smp[u];
        const float bwd = smp[u] - tile[slot][tr + 1][tx];
        g1[u] = (col == 0 ? fwd
                          : (col >= P.wi - 1 ? bwd : 0.5f * (fwd + bwd)))
                / (sc[S_DP] * lamf);
        g2[u] = (tile[slot][tr + 2][tx + 1] - tile[slot][tr][tx + 1])
                * (0.5f / (sc[S_DQ] * lamf));
      }
      // classify: two-tap nodal lookup
      const float v = clampf((smp[u] - sc[S_VLO]) * sc[S_VSCALE], 0.0f,
                             1.0f);
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
      const float seg_lo = fmaxf(lam - sc[S_HALF], l_in[u]);
      const float seg_hi = fminf(lam + sc[S_HALF], l_out[u]);
      const float dt_w = fmaxf(seg_hi - seg_lo, 0.0f) * speed[u];
      const float kk = sc[S_BASE] * dt_w;
      const float a_c = clampf(a_raw, 0.0f, 1.0f - 1e-7f);
      float a = clampf(1.0f - expf(kk * log1pf(-a_c)), 0.0f, 1.0f);
      if (fabsf(kk - 1.0f) < 1e-7f) a = clampf(a_raw, 0.0f, 1.0f);
      if (!(dt_w > 0.0f)) a = 0.0f;
      a = fminf(a, 1.0f - 1e-6f);
      if (COUNT && live[u]) {  // the samples the function needs (bound)
        const bool need = trans[u] > 1e-4f && a > 0.0f;
        n_need[u] += need ? 1 : 0;
        if (MODE >= 1 && need && jpos > 0 && !last_need[u]) ++n_need[u];
        last_need[u] = need;
      }

      float nrm[3] = {0.0f, 0.0f, 0.0f};
      if (MODE >= 1) {
        const float ds = jpos > 0 ? (smp[u] - prev[u]) / sc[S_DZDLAM] : 0.0f;
        const float k1 = ortho ? sc[S_K1O] : p;
        const float k2 = ortho ? sc[S_K2O] : q[u];
        const float ga = (ds - g1[u] * k1 - g2[u] * k2) * sc[S_INVDA];
        const float n1 = -g1[u], n2 = -g2[u], na = -ga;
        const float inv = rsqrtf(n1 * n1 + n2 * n2 + na * na + 1e-12f);
        float total =
            fabsf(sc[S_LD1] * n1 + sc[S_LD2] * n2 + sc[S_LDA] * na) * inv;
        if (LIGHTS) {
          // extra lights in table order: directional |d.n| I / 2, then
          // point lights |(p - x).n| I / (2 |p - x|^3) at the sample's
          // world position x (the fan row's q, the plane's axial z)
          for (int i = 0; i < P.n_dir; ++i) {
            const float4 e = lts[i];
            total += 0.5f * (fabsf(e.x * n1 + e.y * n2 + e.z * na) * inv)
                     * e.w;
          }
          const float x2p = ortho ? q[u] + sc[S_DW2] * lam
                                  : sc[S_EW2] + q[u] * lam;
          const float z_abs = sc[S_ZA0] + sc[S_ZSG] * z_rel;
          for (int i = P.n_dir; i < P.n_lights; ++i) {
            const float4 e = lts[i];
            const float d1p = e.x - x1, d2p = e.y - x2p, dap = e.z - z_abs;
            const float r2 = d1p * d1p + d2p * d2p + dap * dap;
            const float cos_p = fabsf(d1p * n1 + d2p * n2 + dap * na) * inv
                                * rsqrtf(fmaxf(r2, 1e-12f));
            total += 0.5f * (cos_p / fmaxf(r2, 1e-6f)) * e.w;
          }
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
          auto tap = [&](int o) {
            return zlerp<BF16>(__ldg(la0 + o), __ldg(la1 + o), gl, fzl);
          };
          const float l00 = tap(o00), l01 = tap(o01);
          const float l10 = tap(o10), l11 = tap(o11);
          float sh;
          if (BF16) {
            const float wr0 = rb(1.0f - lfr), wr1 = rb(lfr);
            const float wc0 = rb(1.0f - lfc), wc1 = rb(lfc);
            sh = rb(rb(l00) * wr0 + rb(l10) * wr1) * wc0
                 + rb(rb(l01) * wr0 + rb(l11) * wr1) * wc1;
          } else {
            sh = (l00 * (1.0f - lfr) + l10 * lfr) * (1.0f - lfc)
                 + (l01 * (1.0f - lfr) + l11 * lfr) * lfc;
          }
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
      const float aw = trans[u] * a;
      const float add[7] = {aw * rgb[0], aw * rgb[1], aw * rgb[2],
                            aw * nrm[0], aw * nrm[1], aw * nrm[2],
                            aw * (lam * speed[u])};
#pragma unroll
      for (int c = 0; c < 7; ++c)
        acc[u][c] = live[u] ? acc[u][c] + add[c] : acc[u][c];
      trans[u] = live[u] ? trans[u] * (1.0f - a) : trans[u];
      prev[u] = smp[u];
      alive |= live[u] && trans[u] > 1e-4f && exit_t[u] > lam;
    }
    ++jpos;
    // 4. the plane's one barrier: the next stage copied, the next tile
    // published, the termination vote on the planes composited so far
    cp_async_wait_all();
    const int any = __syncthreads_or(alive);
    j = jn;
    jn = jnn;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      smp_c[u] = smp_n[u];
      g1_c[u] = g1_n[u];
      g2_c[u] = g2_n[u];
    }
    if (P.term && !any) break;  // block-uniform
  }
  cp_async_wait_all();  // a block that stopped early leaves no copy behind

  const size_t plane = (size_t)P.hi * P.wi;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!live[u]) continue;
    const size_t o = (size_t)(r_first + ty + WARPS * u) * P.wi + col;
    for (int c = 0; c < 7; ++c) P.out[c * plane + o] = acc[u][c];
    P.out[7 * plane + o] = 1.0f - trans[u];
    if (COUNT && P.pixel_samples != nullptr) P.pixel_samples[o] = n_need[u];
  }
  if (P.block_planes != nullptr && tid == 0)
    P.block_planes[blockIdx.y * gridDim.x + blockIdx.x] = jpos;
  if (COUNT && P.stage_counts != nullptr && tid == 0) {
    atomicAdd(P.stage_counts, n_staged);
    atomicAdd(P.stage_counts + 1, n_direct);
  }
}

typedef void (*KernelFn)(Params);

template <typename T, int MODE, bool FD, bool BF16, bool LIGHTS>
static KernelFn pick_count(bool count) {
  return count ? &swslice_kernel<T, MODE, FD, true, BF16, LIGHTS>
               : &swslice_kernel<T, MODE, FD, false, BF16, LIGHTS>;
}

template <typename T, int MODE, bool FD, bool BF16>
static KernelFn pick_lights(bool lights, bool count) {
  return lights ? pick_count<T, MODE, FD, BF16, true>(count)
                : pick_count<T, MODE, FD, BF16, false>(count);
}

template <typename T, bool BF16>
static KernelFn pick_mode(int mode, bool fd, bool lights, bool count) {
  // mode 0 shades nothing, so it has no light-table variant
  if (mode == 0) return pick_count<T, 0, false, BF16, false>(count);
  if (mode == 1)
    return fd ? pick_lights<T, 1, true, BF16>(lights, count)
              : pick_lights<T, 1, false, BF16>(lights, count);
  return fd ? pick_lights<T, 2, true, BF16>(lights, count)
            : pick_lights<T, 2, false, BF16>(lights, count);
}

template <typename T>
static KernelFn pick_typed(int mode, bool fd, bool bf16, bool lights,
                           bool count) {
  return bf16 ? pick_mode<T, true>(mode, fd, lights, count)
              : pick_mode<T, false>(mode, fd, lights, count);
}

static int elem_size(int dtype) {
  return dtype == 0 ? 4 : dtype == 2 ? 1 : 2;
}

// The variant for (dtype, mode, fd, bf16, lights, count), its threads per
// block and its dynamic shared memory (the RGBA and light tables,
// per-plane bits, windows and schedule, and the slab buffers where the
// grid's rows can be staged: without them the L1 cache keeps that room);
// null for an unknown dtype.
static KernelFn variant(int dtype, int mode, int fd, int bf16, int n_lights,
                        int count, int n_tab, int n_slices, bool staged,
                        int* threads, size_t* smem, int* fp_off,
                        int* ring_off) {
  const bool fd_on = mode >= 1 && fd;
  const bool lights = n_lights > 0;
  KernelFn k;
  switch (dtype) {
    case 0: k = pick_typed<float>(mode, fd_on, bf16, lights, count); break;
    case 1: k = pick_typed<bf16_t>(mode, fd_on, bf16, lights, count); break;
    case 2:
      k = pick_typed<unsigned char>(mode, fd_on, bf16, lights, count);
      break;
    case 3:
      k = pick_typed<unsigned short>(mode, fd_on, bf16, lights, count);
      break;
    default: return nullptr;
  }
  const int words = (2 * (n_slices / 32 + 2) + 3) / 4 * 4;
  *fp_off = 16 * (n_tab + n_lights) + 4 * words;
  *ring_off = *fp_off + (12 * n_slices + 15) / 16 * 16;
  *smem = (size_t)*ring_off
          + (staged ? (size_t)NBUF * CR * CC * elem_size(dtype) : 0);
  *threads = NT;
  return k;
}

// The cp.async size (bytes) at which every window row of this grid can be
// copied: contiguous columns, and base, row, slab stride and row length
// all multiples of it (windows keep voxel indices as shorts). 0: taps are
// read from the grid.
static int copy_bytes(const void* grid, long long sa, long long sr,
                      long long sc, int nr, int nc, int es) {
  if (sc != 1 || nr > 32767 || nc > 32767) return 0;
  const long long abs_sa = sa < 0 ? -sa : sa;
  for (int g = 16; g >= 4; g /= 2)
    if ((uintptr_t)grid % g == 0 && (sr * es) % g == 0
        && (abs_sa * es) % g == 0 && ((long long)nc * es) % g == 0)
      return g;
  return 0;
}

extern "C" {

int ovr_swslice_launch(const void* grid, long long sa, long long sr,
                       long long sc, int na, int nr, int nc, int dtype,
                       const float* tab, int n_tab, const float* scal,
                       const float* pg, int wi, const float* qg, int hi,
                       const int* k0, int n_slices, const float* lgrid,
                       const int* k0l, int la, int lr, int lc,
                       const float* lights, int n_lights, int n_dir,
                       const float* maj, int ma, int mr, int mc, int flip,
                       const float* exit_map, int mode, int fd, int bf16,
                       int term, float* out,
                       int* block_planes, int* pixel_samples,
                       int* stage_counts, void* stream) {
  if (n_tab < 1 || n_tab > MAX_TAB || mode < 0 || mode > 2 || wi < 1
      || hi < 1 || n_slices < 0 || na < 2)
    return (int)cudaErrorInvalidValue;
  // a light table only where the frame is shaded
  if (n_lights < 0 || n_dir < 0 || n_dir > n_lights
      || (n_lights > 0 && (lights == nullptr || mode == 0)))
    return (int)cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  int threads, fp_off, ring_off;
  size_t smem;
  const int count = pixel_samples != nullptr || stage_counts != nullptr;
  const int g = copy_bytes(grid, sa, sr, sc, nr, nc, elem_size(dtype));
  const KernelFn k = variant(dtype, mode, fd, bf16, n_lights, count, n_tab,
                             n_slices, g > 0, &threads, &smem, &fp_off,
                             &ring_off);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  Params P{grid, sa, sr, sc, na, nr, nc, tab, n_tab, scal, pg, wi, qg, hi,
           k0, n_slices, lgrid, k0l, la, lr, lc, lights, n_lights, n_dir,
           maj, ma, mr, mc, flip, exit_map, term, out, block_planes,
           pixel_samples, stage_counts, g, n_slices / 32 + 2, fp_off,
           ring_off};
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_dim((wi + BC - 1) / BC, (hi + BR - 1) / BR);
  k<<<grid_dim, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// Threads per block, dynamic shared memory and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the variant, and
// launch configuration, that a launch with these arguments (and no
// counts) runs.
int ovr_swslice_occupancy(const void* grid, long long sa, long long sr,
                          long long sc, int nr, int nc, int dtype, int mode,
                          int fd, int bf16, int n_lights, int n_tab,
                          int n_slices, int* threads, int* smem_bytes,
                          int* blocks_per_sm) {
  if (dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  int fp_off, ring_off;
  size_t smem;
  const bool staged =
      copy_bytes(grid, sa, sr, sc, nr, nc, elem_size(dtype)) > 0;
  const KernelFn k = variant(dtype, mode, fd, bf16, mode >= 1 ? n_lights : 0,
                             0, n_tab, n_slices, staged, threads, &smem,
                             &fp_off, &ring_off);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, *threads, smem);
}

const char* ovr_swslice_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

void ovr_swslice_block_dims(int* rows, int* cols) {
  *rows = BR;
  *cols = BC;
}

}  // extern "C"
