// Hopper (sm_90a) prefill attention of DeepSeek-V2's multi-head latent
// attention (MLA), after the projections. It replaces no Pallas kernel: the
// JAX package has no DeepSeek-V2 encoder. It was added for the port's
// dialog-history encoder (cse_tpu_torch/models/deepseek_v2.py::mla), whose
// plain-PyTorch attention wrote fp32 scores of B H T^2 values to device
// memory and passed over them four times (bias-and-scale add, softmax, cast
// to bf16, the P.V product), and computed every (query, key) pair: the
// causal upper half and the left padding too. The host wrapper is
// cse_tpu_torch/ops/mla.py::mla_attention; its plain twin,
// mla_attention_plain, is the arithmetic this kernel replaces.
//
// For batch row b, head h and a tile of 128 query rows, over the live key
// tiles of 128 keys:
//   S = q_nope . k_nope^T + q_pe . k_pe^T   (bf16 products, fp32 sums)
//   p = exp2(S * scale * log2(e) - m)        (online softmax in fp32; the
//                                             scale applied to the fp32 sum)
//   O += bf16(p) . V                         (fp32 sums)
// then O / sum(p), stored bf16 into o [B, T, H DV] at the head's columns,
// the layout o_proj reads. Query i of row b reads key j when f_b <= j <= i,
// f_b = first[b], the row's first real token (left padding). A query row
// with no such key (a pad row, i < f_b) is written 0; real rows never read
// pad rows, so nothing downstream of a real token sees them.
//
// Inputs, read in place with no copy: q [B, T, H (DN + DR)] (q_proj's output,
// the rope already applied to each head's DR columns), kv [B, T, H (DN + DV)]
// (kv_b's output: each head's k_nope then v), k_pe [B, T, DR] (the one rope
// key every head shares: read once a key tile, from its own tensor). All
// bf16, rows 16-byte aligned; first [B] int32 on the device.
//
// What bounds it: at the history cell's shape (B 10, T 2048, H 16, DN 128,
// DR 64, DV 128) the real causal pairs' products are ~1.2-2.2e11 operations
// against ~0.4 GB of q, kv and o: bound by the tensor cores (295 operations
// a byte is the H100's ridge). So the design keeps the tensor cores fed and
// computes no dead pair:
//   - tiles with no live pair are never visited: a block walks key tiles
//     from the diagonal down to the one holding f_b, and a query tile wholly
//     before f_b writes its zeros and stops. The bounds come from first[b]
//     on the device; nothing is read back to the host. Only the diagonal
//     tile and f_b's tile mask pairs element by element;
//   - one block of 384 threads a (query tile, b, h), launched in groups of 8
//     (b, h) pairs, each group's longest query tiles (most key tiles) first,
//     so that the blocks in flight read the same K and V from L2 and device
//     memory sees each (b, h)'s K and V about once. Warp 0 loads by TMA: the
//     Q tile once (it stays in shared memory for the whole key loop), then each key
//     tile's K_nope and K_pe boxes through a 2-stage ring and its V boxes
//     through another, so loads run ahead of the products;
//   - two consumer warpgroups own 64 query rows each and run both products
//     with wgmma (S = Q K^T with both operands from shared memory, K-major;
//     O += P V with P from registers, V N-major through the transpose bit).
//     Each issues tile j's S product and tile j - 1's P.V product together,
//     then does tile j's softmax while the P.V product runs; and the two
//     warpgroups take turns at issuing (two named barriers), so one's
//     softmax runs under the other's products (FA3's ping-pong);
//   - S, P and the softmax statistics never leave registers; O is staged in
//     the warpgroup's own (finished) Q rows and stored in whole 16-byte
//     lines.
// Shared memory at (128, 64, 128): Q 48 KB + 2 x (K 48 KB + V 32 KB) = 208
// KB. Widths are a template: DN, DV <= 128 and DR <= 64, multiples of 16;
// instantiated for DeepSeek-V2 / -Lite / V3's (128, 64, 128) and the tests'
// (32, 16, 32). A width under 64 is loaded as a 64-wide box whose columns
// past it are never read into a product (S's k-steps stop at the width; a
// narrow V's 64-column product is stored only in its first DV columns).
#include "common.cuh"

namespace {

namespace mla {
constexpr int BM = 128, BN = 128;  // query rows, keys a tile
constexpr int BOX = BM * 128;      // 16 KB: [128 rows][64 bf16] with the 128-byte swizzle
constexpr int STAGES = 2;
constexpr int GROUP = 8;  // (row, head) pairs launched together: 8 x 1.25 MB of K and V at (128, 64, 128)

template <int DN, int DR, int DV>
struct Plan {
  static_assert(DN % 16 == 0 && DN <= 128 && DR % 16 == 0 && DR <= 64 && DV % 16 == 0 && DV <= 128, "MLA widths");
  static constexpr int NB = (DN + 63) / 64, VB = (DV + 63) / 64;  // nope boxes, value boxes
  static constexpr int QB = NB + 1, KB = NB + 1;                  // + the rope box
  static constexpr int OFF_K = QB * BOX, OFF_V = OFF_K + STAGES * KB * BOX, OFF_BAR = OFF_V + STAGES * VB * BOX;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (1 + 4 * STAGES);
};
}  // namespace mla

// 3-D tile: global (c0 = column, c1 = token, c2 = batch row) -> shared, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// The arrivals of the consumer loop are predicated instructions, not
// branches: a branch between a wgmma's issue and its wait makes ptxas
// serialise every wgmma of the kernel.
__device__ __forceinline__ void named_arrive_if(bool pred, int id, int threads) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p bar.arrive %0, %1;\n}\n" ::"r"(id), "r"(threads),
               "r"((int)pred)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_if(bool pred, uint64_t* bar) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
                   smem_addr(bar)),
               "r"((int)pred)
               : "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 from shared memory, both
// K-major (no transpose bit): S = Q K^T with K's rows the keys
__device__ __forceinline__ void wgmma_m64n128k16_kk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A bf16 from registers (the
// m16n8k16 A fragment of the thread's warp: rows 16 (t / 32) + (t % 32) / 4
// and + 8, columns 2 (t % 4) and + 8), B from shared memory N-major (the
// transpose bit): O += P V with V's rows the keys
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// the same at N 64 (a value width of 64 or less: one box)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S[64 x 128] = the warpgroup's 64 Q rows (q: its rows of the Q tile's first
// box) . the key tile's K^T, over DN nope columns and DR rope columns
template <int DN, int DR>
__device__ __forceinline__ void qk_product(float (&s)[64], const unsigned char* q, const unsigned char* k) {
  using namespace mla;
  constexpr int NB = (DN + 63) / 64;
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (64 * i + 16 * kk < DN)
        wgmma_m64n128k16_kk(s, desc_k_major(q + i * BOX, kk), desc_k_major(k + i * BOX, kk), i + kk > 0);
#pragma unroll
  for (int kk = 0; kk < DR / 16; ++kk)
    wgmma_m64n128k16_kk(s, desc_k_major(q + NB * BOX, kk), desc_k_major(k + NB * BOX, kk), 1);
}

// O += P . V over the tile's 128 keys: P's k-step kk is the bf16 pairs
// p[4 kk .. 4 kk + 3] (S's n8 tiles 2 kk and 2 kk + 1 in the A fragment's
// order); V's k-step is 16 key rows (2048 bytes) on, its 64-column boxes BOX apart
template <int VB>
__device__ __forceinline__ void pv_product(float (&o)[32 * VB], const unsigned (&p)[32], const unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const unsigned a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t db = gmma_desc_sw128(v + kk * 2048, mla::BOX, 1024);
    if constexpr (VB == 2) wgmma_m64n128k16_rs(o, a, db);
    else wgmma_m64n64k16_rs(o, a, db);
  }
}

// One key tile's online softmax on the warpgroup's S [64 x 128] (the
// thread's rows row and row + 8, its columns 8 jj + 2 t4 + e % 2 of each n8
// tile jj): with MASK, dead pairs (key > query, or key < f) to -inf; m (the
// running max of S x scale_log2) and alpha (the factor for what was summed
// before) per row; s becomes p = exp2(S x scale_log2 - m); l (the thread's
// part of the row sums) is rescaled and added to. A row with no live key yet
// keeps m = -inf and p = 0.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
                                             int f, int row, int t4, float scale_log2) {
  if constexpr (MASK) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * jj + 2 * t4 + (e & 1), r = row + 8 * (e >> 1);
        s[4 * jj + e] = key > r || key < f ? -INFINITY : s[4 * jj + e];
      }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h] * scale_log2);
    mu[h] = mn == -INFINITY ? 0.f : mn;
    alpha[h] = exp2f(m[h] - mu[h]);
    m[h] = mn;
  }
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = exp2f(fmaf(s[4 * jj + e], scale_log2, -mu[e >> 1]));
      s[4 * jj + e] = v;
      rs[e >> 1] += v;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

template <int DN, int DR, int DV>
__global__ void __launch_bounds__(WS_THREADS, 1)
mla_prefill_bf16_kernel(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmKV,
                        const __grid_constant__ CUtensorMap tmPE, const int* __restrict__ first,
                        bf16* __restrict__ out, int B, int T, int H, float scale_log2) {
  using namespace mla;
  using P = Plan<DN, DR, DV>;
  constexpr int NB = P::NB, VB = P::VB, ON = 64 * VB;  // ON: the P.V product's columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + P::OFF_K;
  unsigned char* Vs = smem + P::OFF_V;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::OFF_BAR);
  uint64_t* qbar = bars;
  const TmaRing<STAGES> kring{bars + 1};               // K_nope + K_pe boxes of a key tile
  const TmaRing<STAGES> vring{bars + 1 + 2 * STAGES};  // V boxes of a key tile

  // blocks in groups of GROUP (row, head) pairs, a group's blocks launched
  // together, its longest query tiles (most key tiles) first: the blocks in
  // flight share their pairs' K and V through L2
  const int nqt = (T + BM - 1) / BM, group = blockIdx.x / (GROUP * nqt), within = blockIdx.x % (GROUP * nqt);
  const int gsize = min(GROUP, B * H - group * GROUP);
  const int qt = nqt - 1 - within / gsize, bh = group * GROUP + within % gsize;
  const int b = bh / H, hd = bh % H, q0 = qt * BM;
  const int f = first[b];
  // live key tiles: qt (the diagonal) down to the one holding f; none when the
  // query tile's last row lies before f (all its rows are pad rows)
  const int n = min(q0 + BM, T) - 1 >= f ? qt - f / BN + 1 : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    kring.init(8);  // one release per consumer warp
    vring.init(8);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup: warp 0 loads
    ws_producer_regs();
    if (warp == 0 && lane == 0 && n > 0) {
      const int qc = hd * (DN + DR), kc = hd * (DN + DV);
      mbar_expect_tx(qbar, P::QB * BOX);
#pragma unroll
      for (int i = 0; i < NB; ++i) tma_load_3d(Qs + i * BOX, &tmQ, qc + 64 * i, q0, b, qbar);
      tma_load_3d(Qs + NB * BOX, &tmQ, qc + DN, q0, b, qbar);
      for (int j = 0; j < n; ++j) {
        const int k0 = (qt - j) * BN;
        unsigned char* ks = Ks + (j % STAGES) * (P::KB * BOX);
        uint64_t* kb = kring.fill(j, P::KB * BOX);
#pragma unroll
        for (int i = 0; i < NB; ++i) tma_load_3d(ks + i * BOX, &tmKV, kc + 64 * i, k0, b, kb);
        tma_load_3d(ks + NB * BOX, &tmPE, 0, k0, b, kb);
        unsigned char* vs = Vs + (j % STAGES) * (VB * BOX);
        uint64_t* vb = vring.fill(j, VB * BOX);
#pragma unroll
        for (int i = 0; i < VB; ++i) tma_load_3d(vs + i * BOX, &tmKV, kc + DN + 64 * i, k0, b, vb);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the tile
  ws_consumer_regs();
  const int wg = (warp >> 2) - 1, g = lane >> 2, t4 = lane & 3;
  const int row = q0 + wg * 64 + (warp & 3) * 16 + g;  // the thread's rows: row, row + 8
  float o[ON / 2];
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // running max (scaled, log2) and partial sums
  if (n > 0) {
    const unsigned char* qw = Qs + wg * (64 * 128);
    unsigned p[32];
    float s[64], alpha[2];
    named_arrive_if(wg == 1, 1, 256);  // warpgroup 0 issues first
    mbar_wait(qbar, 0);
    // Tile 0's S (the diagonal tile) and its softmax; then step j (1 .. n - 1)
    // issues tile j's S and tile j - 1's P.V together and does tile j's
    // softmax while the P.V runs; the last tile's P.V after them. A
    // warpgroup issues in its turn and hands the turn over (warpgroup 1 hands
    // none after its last). Masks: the diagonal tile and the last (the one
    // holding f); the steps between run none, each step free of branches.
    kring.wait(0);
    named_sync(1 + wg, 256);
    wgmma_fence();
    qk_product<DN, DR>(s, qw, Ks);
    wgmma_commit();
    named_arrive_if(!(wg == 1 && n == 1), 2 - wg, 256);
    wgmma_wait0();
    fence_regs(s);
    mbar_arrive_if(lane == 0, &kring.bars[STAGES + 0]);
    softmax_tile<true>(s, m, l, alpha, qt * BN, f, row, t4, scale_log2);
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    auto step = [&](int j, auto mask) {
      kring.wait(j);
      vring.wait(j - 1);
      named_sync(1 + wg, 256);
      wgmma_fence();
      qk_product<DN, DR>(s, qw, Ks + (j % STAGES) * (P::KB * BOX));
      wgmma_commit();
      pv_product<VB>(o, p, Vs + ((j - 1) % STAGES) * (VB * BOX));
      wgmma_commit();
      named_arrive_if(!(wg == 1 && j == n - 1), 2 - wg, 256);
      wgmma_wait1();  // tile j's S
      fence_regs(s);
      mbar_arrive_if(lane == 0, &kring.bars[STAGES + j % STAGES]);
      softmax_tile<decltype(mask)::value>(s, m, l, alpha, (qt - j) * BN, f, row, t4, scale_log2);
      wgmma_wait0();  // tile j - 1's P.V
      fence_regs(o);
      mbar_arrive_if(lane == 0, &vring.bars[STAGES + (j - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < ON / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e >> 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    for (int j = 1; j < n - 1; ++j) step(j, std::false_type{});
    if (n > 1) step(n - 1, std::true_type{});
    vring.wait(n - 1);
    wgmma_fence();
    pv_product<VB>(o, p, Vs + ((n - 1) % STAGES) * (VB * BOX));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive_if(lane == 0, &vring.bars[STAGES + (n - 1) % STAGES]);
  }

  // ---- epilogue: O / sum p (0 for a pad row) as bf16, staged in the
  // warpgroup's own rows of the Q tile (its products have retired), then
  // stored a 16-byte line at a time, DV * 2 contiguous bytes a row
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    inv[h] = lt > 0.f ? 1.f / lt : 0.f;
  }
  unsigned char* stage = Qs + wg * (64 * 128);
  // 16-byte chunk c of staged row r (0 .. 63): box c / 8, swizzled within the row
  auto chunk = [&](int r, int c) { return stage + (c >> 3) * BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4); };
  fence_proxy_async();
  const int rl = (warp & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * i + 2 * t4;
      *reinterpret_cast<unsigned*>(chunk(rl + 8 * h, c >> 3) + (c & 7) * 2) =
          pack_bf16(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
    }
  named_sync(3 + wg, 128);
  constexpr int CH = DV / 8;  // 16-byte chunks a row
  const int tid = threadIdx.x - 128 * (wg + 1);
  const long long ld = (long long)H * DV;
  bf16* base = out + ((long long)b * T + q0 + wg * 64) * ld + hd * DV;
#pragma unroll
  for (int idx = tid; idx < 64 * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH;
    if (q0 + wg * 64 + r < T)
      *reinterpret_cast<uint4*>(base + r * ld + c * 8) = *reinterpret_cast<const uint4*>(chunk(r, c));
  }
}

// a row-major [batch][rows][cols] bf16 tensor read in [128 rows][64 columns]
// boxes of one batch row with the 128-byte swizzle, zero fill out of bounds
inline bool tensor_map_3d(CUtensorMap* m, const void* ptr, long long cols, long long rows, long long batch) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc || reinterpret_cast<uintptr_t>(ptr) % 16 || (cols * 2) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * 2), (cuuint64_t)(cols * 2 * rows)};
  const cuuint32_t box[3] = {64, (cuuint32_t)mla::BM, 1}, es[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DN, int DR, int DV>
cudaError_t launch_mla(const void* q, const void* kv, const void* kpe, const int* first, void* out, int B, int T,
                       int H, float scale, cudaStream_t st) {
  using P = mla::Plan<DN, DR, DV>;
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  static bool ready = false;
  const cudaError_t e = allow_smem(mla_prefill_bf16_kernel<DN, DR, DV>, P::SMEM, ready);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tkv, tpe;
  if (!tensor_map_3d(&tq, q, (long long)H * (DN + DR), T, B) ||
      !tensor_map_3d(&tkv, kv, (long long)H * (DN + DV), T, B) || !tensor_map_3d(&tpe, kpe, DR, T, B))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((T + mla::BM - 1) / mla::BM) * B * H;
  mla_prefill_bf16_kernel<DN, DR, DV><<<(unsigned)blocks, WS_THREADS, P::SMEM, st>>>(
      tq, tkv, tpe, first, static_cast<bf16*>(out), B, T, H,
      (float)((double)scale * 1.4426950408889634));  // x log2(e): the kernel takes exp2
  return cudaGetLastError();
}

template <int DN, int DR, int DV>
cudaError_t mla_info(int* info) {
  using P = mla::Plan<DN, DR, DV>;
  static bool ready = false;
  const cudaError_t e = allow_smem(mla_prefill_bf16_kernel<DN, DR, DV>, P::SMEM, ready);
  if (e != cudaSuccess) return e;
  info[0] = WS_THREADS;
  info[1] = (int)P::SMEM;
  return kernel_info(reinterpret_cast<const void*>(mla_prefill_bf16_kernel<DN, DR, DV>), WS_THREADS, P::SMEM,
                     info + 2);
}

}  // namespace

extern "C" {

// o [B, T, H dv] bf16 = MLA prefill attention of q [B, T, H (dn + dr)], kv
// [B, T, H (dn + dv)], k_pe [B, T, dr] (bf16) with the causal mask and each
// row's first real token first [B] (int32, on the device); softmax scale
// `scale`. (dn, dr, dv) in {(128, 64, 128), (32, 16, 32)}.
int cse_mla_prefill(const void* q, const void* kv, const void* kpe, const void* first, void* o, int B, int T, int H,
                    int dn, int dr, int dv, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* f = static_cast<const int*>(first);
  if (dn == 128 && dr == 64 && dv == 128) return launch_mla<128, 64, 128>(q, kv, kpe, f, o, B, T, H, scale, st);
  if (dn == 32 && dr == 16 && dv == 32) return launch_mla<32, 16, 32>(q, kv, kpe, f, o, B, T, H, scale, st);
  return cudaErrorInvalidValue;
}

// info[5]: {threads, dynamic shared bytes, registers a thread, local bytes a
// thread, resident blocks per SM} of the kernel at (dn, dr, dv)
int cse_mla_prefill_info(int dn, int dr, int dv, int* info) {
  if (dn == 128 && dr == 64 && dv == 128) return mla_info<128, 64, 128>(info);
  if (dn == 32 && dr == 16 && dv == 32) return mla_info<32, 16, 32>(info);
  return cudaErrorInvalidValue;
}

}  // extern "C"
