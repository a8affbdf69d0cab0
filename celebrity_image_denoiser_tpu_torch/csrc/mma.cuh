// The PTX the kernels need, and nothing else: asynchronous 16- and
// 4-byte copies into shared memory, ldmatrix (x4 and x2), the warp matrix
// instructions (mma.sync m16n8k16 in bf16, m16n8k32 in s8 with s32
// accumulation), the warpgroup ones (wgmma m64n64k16 in bf16, m64n64k32
// in s8, m64n64k8 and m64n128k8 in tf32, A in registers and B read from
// shared memory through a descriptor), the tf32 rounding, setmaxnreg, a
// warp barrier, a warp shuffle, and the shared-memory barriers (mbarrier)
// that copies and threads arrive on.
//
// Every wrapper has two bodies.  nvcc compiles the PTX.  With
// CID_EMULATE_MMA defined (only the CPU tests' g++ build defines it) the
// same wrapper computes the same result in plain C++ from the same fragment
// and descriptor layout, so the kernels' indexing can be checked without a
// card.  The emulation needs from its host ("mock"):
//   mock::smem_base()          the block's dynamic shared memory, 1024-aligned
//   mock::warp_sync()          a barrier over the calling thread's warp
//   mock::warpgroup_sync()     a barrier over its warpgroup (4 warps)
//   mock::warp_scratch()       >= 192 uint32 shared by the warp
//   mock::warpgroup_scratch()  >= 512 uint32 shared by the warpgroup
// and, for the mbarriers, std::atomic_ref and std::this_thread::yield.
//
// Fragment layouts (lane = thread % 32, g = lane / 4, q = lane % 4):
//   A, 16 rows x 16 k, four registers of two bf16 (low half = lower k):
//     a[0] = A[g][2q..2q+1]       a[1] = A[g+8][2q..2q+1]
//     a[2] = A[g][2q+8..2q+9]     a[3] = A[g+8][2q+8..2q+9]
//     ldmatrix_x4 gives exactly this when lane l passes the address of the
//     16 bytes at row (l % 8) + 8 * ((l / 8) % 2), k = 8 * (l / 16).
//   B of mma.sync, 16 k x 8 n: b[0] = B[2q..2q+1][g], b[1] = B[2q+8..2q+9][g].
//   C/D of mma.sync, 16 x 8 f32: d[0..1] = D[g][2q..2q+1], d[2..3] = D[g+8][..].
//   s8 (m16n8k32), four s8 to a register, the lowest k in the lowest byte:
//     A, 16 rows x 32 k: a[0] = A[g][4q..4q+3]   a[1] = A[g+8][4q..4q+3]
//                        a[2] = A[g][4q+16..]    a[3] = A[g+8][4q+16..]
//     i.e. byte for byte the bf16 A tile (16 rows of 32 bytes), so the same
//     ldmatrix_x4 addressing gives it.  B, 32 k x 8 n, "col" (k contiguous
//     for each n): b[0] = B[4q..4q+3][g], b[1] = B[4q+16..4q+19][g]; with B
//     stored as 8 rows n of 32 bytes, ldmatrix_x2 gives it when lane l
//     (< 16) passes row l % 8, bytes 16 * (l / 8).  D, 16 x 8 s32, as the f32
//     D above.
//   D of wgmma, 64 x 64 f32: warp w of the warpgroup owns rows 16w..16w+15,
//     and for each 8-column block i: d[4i..4i+1] = D[16w+g][8i+2q..8i+2q+1],
//     d[4i+2..4i+3] = D[16w+g+8][...].  Its A is the A above, per warp.
//   B of wgmma, 16 k x 64 n in shared memory, n contiguous ("MN-major",
//     transposed B), 128-byte swizzle: row k is 128 bytes at
//     start + (k / 8) * SBO + (k % 8) * 128, and the 16-byte piece j of a row
//     sits at piece j ^ (address bits 7..9), i.e. j ^ (k % 8) when start is a
//     multiple of 1024.
//   s8 wgmma (m64n64k32, s32 accumulators laid out as the f32 D above): A,
//     per warp, is the s8 mma.sync A tile (16 rows x 32 k).  B, 32 k x 64 n,
//     is K-major (k contiguous for each n: the only form wgmma takes for
//     8-bit types) with the 32-byte swizzle: column n is the 32 bytes at
//     start + (n / 8) * SBO + (n % 8) * 32, and its 16-byte piece j sits at
//     piece j ^ (address bit 7), i.e. j ^ ((n >> 2) & 1) when start is a
//     multiple of 256 -- conv_s8.cuh's row layout, with SBO = 256.
//   tf32 wgmma (m64n64k8, f32 accumulators laid out as the f32 D above): a
//     tf32 operand is an f32 whose low 13 bits the tensor cores ignore.  A,
//     per warp, 16 rows x 8 k, one value a register: a[0] = A[g][q],
//     a[1] = A[g+8][q], a[2] = A[g][q+4], a[3] = A[g+8][q+4] -- what
//     ldmatrix_x4 gives from rows of 16-byte pieces (4 f32) with the bf16
//     addressing above (piece = l / 16).  B, 8 k x 64 n, is K-major (the
//     only form wgmma takes for 32-bit types): column n is the 32 bytes of
//     its 8 k, laid out exactly as the s8 B above (32-byte swizzle, SBO 256,
//     the same descriptor).  m64n128k8 in tf32 is the same with 128
//     columns: 16 groups of 8 columns, d[64] (d[4i..4i+3] for column block
//     i < 16 as above).
#pragma once

#include <cstdint>
#ifdef CID_EMULATE_MMA
#include <atomic>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#endif

#include "common.cuh"

namespace cid {
namespace mma {

constexpr uint64_t kDescSwizzle128 = 1ull << 62;  // layout type B128
constexpr uint64_t kDescSwizzle32 = 3ull << 62;   // layout type B32

// Descriptor of a wgmma B tile as laid out above.  start: shared-memory
// address (multiple of 1024); sbo_bytes: distance between 8-row groups of k.
// The leading-dimension offset is unused at n = 64 and set to one unit.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t start,
                                               uint32_t sbo_bytes) {
  return kDescSwizzle128 | ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (1ull << 16) | (uint64_t)((start >> 4) & 0x3FFF);
}

// Descriptor of an s8 or tf32 wgmma B tile (K-major, 32-byte swizzle) as
// laid out above: start a multiple of 256, 8-column groups 256 bytes apart; the
// leading-dimension offset is unused (one k32 step spans the swizzle's
// width) and set to one unit.
__device__ __forceinline__ uint64_t wgmma_desc_k32(uint32_t start) {
  return kDescSwizzle32 | ((uint64_t)(256 >> 4) << 32) | (1ull << 16) |
         (uint64_t)((start >> 4) & 0x3FFF);
}

#ifndef CID_EMULATE_MMA
// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros instead when !valid
// (src must still be a readable address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronously, through L1; zero instead when
// !valid (src must still be a readable address).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += A (16x32, row) * B (32x8, col), s8 in, s32 accumulate (exact: the
// conv sums stay far below 2^31).
__device__ __forceinline__ void mma_m16n8k32_s8(int (&d)[4],
                                                const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Move registers between warpgroups: every warp of a warpgroup executes the
// same one; N a multiple of 8.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (64x64 f32, this warpgroup's) += A (64x16 bf16, registers) * B (16x64
// bf16, shared memory, n contiguous).  Asynchronous: a and d may not be
// touched until the group is committed and waited for.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64x64 s32, this warpgroup's) = A (64x32 s8, registers) * B (32x64 s8,
// shared memory, K-major) + (accumulate ? d : 0).  Asynchronous as above.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc,
                                                   bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"((int)accumulate));
}

// d (64x64 f32, this warpgroup's) = A (64x8 tf32, registers) * B (8x64
// tf32, shared memory, K-major, 32-byte swizzle) + (accumulate ? d : 0).
// Asynchronous as above.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc,
                                                    bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"((int)accumulate));
}

// d (64x128 f32, this warpgroup's) = A (64x8 tf32, registers) * B (8x128
// tf32, shared memory, K-major, 32-byte swizzle) + (accumulate ? d : 0).
// Asynchronous as above.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc,
                                                     bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"((int)accumulate));
}

// The f32 value v (given as its bits) as hi + lo, two tf32 values: hi = v
// rounded to tf32 (nearest, ties away from zero), lo = v - hi (exact in
// f32) rounded the same way.  lo is formed from the rounded hi, never from
// v's raw upper bits; |v - hi - lo| <= 2^-22 |v| or so.
__device__ __forceinline__ void tf32_split(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(v)));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(lo)
      : "f"(__uint_as_float(v) - __uint_as_float(hi)));
}

// A barrier over the calling thread's warp (its shared-memory writes are
// visible to the warp after it).
__device__ __forceinline__ void warp_sync() { __syncwarp(); }

// v of lane (lane ^ m) of the calling thread's warp (all 32 lanes call it).
__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

// A shared-memory barrier (8 bytes at addr, 8-aligned) whose phase
// completes after `count` arrivals.  Initialised by one thread; the block
// then meets at __syncthreads before any other use.
__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(addr), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival of the calling thread.
__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          addr)
      : "memory");
}
// One arrival once every cp.async this thread started has landed (counted
// among the barrier's `count`).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t addr) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(addr)
               : "memory");
}
// Wait until the phase of parity `parity` has completed (the barrier's
// current phase has the other parity).
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}
// Order this thread's generic-proxy shared-memory accesses before the
// async proxy's (wgmma's reads of B).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#else
// ---------------------------------------------------------- emulation ----

inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - ::mock::smem_base());
}

namespace emu {
struct Copy { uint32_t dst; int n; unsigned char bytes[16]; };
// groups of copies this thread has started; the last one is still open
inline thread_local std::vector<std::vector<Copy>> groups(1);
inline float bf16_at(uint32_t word, int half) {
  const uint32_t u = (half ? (word >> 16) : (word & 0xFFFFu)) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int s8_at(uint32_t word, int byte) {
  return (int)(int8_t)((word >> (8 * byte)) & 0xFFu);
}
// the value the tensor cores read from a tf32 operand: its low 13 bits
// dropped
inline float tf32_at(uint32_t word) {
  const uint32_t u = word & 0xFFFFE000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// cvt.rna.tf32.f32: to nearest on the magnitude, ties away from zero (NaN
// and infinity kept)
inline uint32_t tf32_rna(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7FFFFFFFu) >= 0x7F800000u) return u;
  return (u + 0x1000u) & 0xFFFFE000u;
}
// element (row, k) of a 16x16 A tile whose fragments lie at frag[lane][4]
inline float a_at(const uint32_t* frag, int row, int k) {
  const int lane = (row % 8) * 4 + (k % 8) / 2;
  return bf16_at(frag[lane * 4 + (row / 8) + 2 * (k / 8)], k % 2);
}
}  // namespace emu

// The copy is deferred until a wait retires its group, as on the card: a
// missing commit or wait leaves the destination unwritten.
inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  emu::Copy c{dst, 16, {}};
  if (valid) std::memcpy(c.bytes, src, 16);
  emu::groups.back().push_back(c);
}
inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  emu::Copy c{dst, 4, {}};
  if (valid) std::memcpy(c.bytes, src, 4);
  emu::groups.back().push_back(c);
}
inline void cp_async_commit() { emu::groups.emplace_back(); }
template <int N>
inline void cp_async_wait() {
  while ((int)emu::groups.size() - 1 > N) {
    for (const emu::Copy& c : emu::groups.front())
      std::memcpy(::mock::smem_base() + c.dst, c.bytes, c.n);
    emu::groups.erase(emu::groups.begin());
  }
}

inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  uint32_t* s = ::mock::warp_scratch();
  const int lane = threadIdx.x % 32;
  s[lane] = addr;
  ::mock::warp_sync();
  for (int i = 0; i < 4; ++i)
    std::memcpy(&r[i],
                ::mock::smem_base() + s[i * 8 + lane / 4] + (lane % 4) * 4, 4);
  ::mock::warp_sync();
}

inline void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  uint32_t* s = ::mock::warp_scratch();
  const int lane = threadIdx.x % 32;
  s[lane] = addr;
  ::mock::warp_sync();
  for (int i = 0; i < 2; ++i)
    std::memcpy(&r[i],
                ::mock::smem_base() + s[i * 8 + lane / 4] + (lane % 4) * 4, 4);
  ::mock::warp_sync();
}

inline void mma_m16n8k32_s8(int (&d)[4], const uint32_t (&a)[4],
                            const uint32_t (&b)[2]) {
  uint32_t* sa = ::mock::warp_scratch();  // [32][4]
  uint32_t* sb = sa + 128;                // [32][2]
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) sa[lane * 4 + i] = a[i];
  for (int i = 0; i < 2; ++i) sb[lane * 2 + i] = b[i];
  ::mock::warp_sync();
  for (int e = 0; e < 4; ++e) {
    const int row = lane / 4 + 8 * (e / 2), col = 2 * (lane % 4) + e % 2;
    int acc = d[e];
    for (int k = 0; k < 32; ++k)
      acc += emu::s8_at(sa[((row % 8) * 4 + (k % 16) / 4) * 4 + row / 8 +
                           2 * (k / 16)], k % 4) *
             emu::s8_at(sb[(col * 4 + (k % 16) / 4) * 2 + k / 16], k % 4);
    d[e] = acc;
  }
  ::mock::warp_sync();
}

inline void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                         const uint32_t (&b)[2]) {
  uint32_t* sa = ::mock::warp_scratch();  // [32][4]
  uint32_t* sb = sa + 128;                // [32][2]
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) sa[lane * 4 + i] = a[i];
  for (int i = 0; i < 2; ++i) sb[lane * 2 + i] = b[i];
  ::mock::warp_sync();
  for (int e = 0; e < 4; ++e) {
    const int row = lane / 4 + 8 * (e / 2), col = 2 * (lane % 4) + e % 2;
    float acc = d[e];
    for (int k = 0; k < 16; ++k)
      acc += emu::a_at(sa, row, k) *
             emu::bf16_at(sb[(col * 4 + (k % 8) / 2) * 2 + k / 8], k % 2);
    d[e] = acc;
  }
  ::mock::warp_sync();
}

template <int N>
inline void setmaxnreg_inc() {}
template <int N>
inline void setmaxnreg_dec() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}

inline void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t desc) {
  uint32_t* sa = ::mock::warpgroup_scratch();  // [4 warps][32][4]
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  for (int i = 0; i < 4; ++i) sa[t * 4 + i] = a[i];
  ::mock::warpgroup_sync();
  if ((desc >> 62) != 1) std::abort();  // only the 128-byte swizzle is used
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  for (int e = 0; e < 32; ++e) {
    const int row = lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    float acc = d[e];
    for (int k = 0; k < 16; ++k) {
      uint32_t off = start + (k / 8) * sbo + (k % 8) * 128 + col * 2;
      off ^= ((off >> 7) & 7) << 4;
      uint16_t bits;
      std::memcpy(&bits, ::mock::smem_base() + off, 2);
      acc += emu::a_at(sa + warp * 128, row, k) * emu::bf16_at(bits, 0);
    }
    d[e] = acc;
  }
  ::mock::warpgroup_sync();
}

inline void wgmma_m64n64k32_s8(int (&d)[32], const uint32_t (&a)[4],
                               uint64_t desc, bool accumulate) {
  uint32_t* sa = ::mock::warpgroup_scratch();  // [4 warps][32][4]
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  for (int i = 0; i < 4; ++i) sa[t * 4 + i] = a[i];
  ::mock::warpgroup_sync();
  // only K-major B with the 32-byte swizzle and 256 bytes between 8-column
  // groups is used
  if ((desc >> 62) != 3 || ((desc >> 32) & 0x3FFF) != 16) std::abort();
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t* fa = sa + warp * 128;
  for (int e = 0; e < 32; ++e) {
    const int row = lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    int acc = accumulate ? d[e] : 0;
    for (int k = 0; k < 32; ++k) {
      uint32_t off = start + (col / 8) * 256 + (col % 8) * 32 + k;
      off ^= ((off >> 7) & 1) << 4;
      const int b = (int)(int8_t)::mock::smem_base()[off];
      acc += emu::s8_at(fa[((row % 8) * 4 + (k % 16) / 4) * 4 + row / 8 +
                           2 * (k / 16)], k % 4) * b;
    }
    d[e] = acc;
  }
  ::mock::warpgroup_sync();
}

namespace emu {
// d (64 x N f32, this warpgroup's) = A (64x8 tf32) * B (8 x N, K-major,
// 32-byte swizzle) + (accumulate ? d : 0)
template <int N>
inline void wgmma_k8_tf32(float* d, const uint32_t (&a)[4], uint64_t desc,
                          bool accumulate) {
  uint32_t* sa = ::mock::warpgroup_scratch();  // [4 warps][32][4]
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  for (int i = 0; i < 4; ++i) sa[t * 4 + i] = a[i];
  ::mock::warpgroup_sync();
  // only K-major B with the 32-byte swizzle and 256 bytes between 8-column
  // groups is used
  if ((desc >> 62) != 3 || ((desc >> 32) & 0x3FFF) != 16) std::abort();
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t* fa = sa + warp * 128;
  for (int e = 0; e < N / 2; ++e) {
    const int row = lane / 4 + 8 * ((e % 4) / 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    float acc = accumulate ? d[e] : 0.f;
    for (int k = 0; k < 8; ++k) {
      uint32_t off = start + (col / 8) * 256 + (col % 8) * 32 + k * 4;
      off ^= ((off >> 7) & 1) << 4;
      uint32_t b;
      std::memcpy(&b, ::mock::smem_base() + off, 4);
      acc += tf32_at(fa[((row % 8) * 4 + k % 4) * 4 + row / 8 +
                        2 * (k / 4)]) *
             tf32_at(b);
    }
    d[e] = acc;
  }
  ::mock::warpgroup_sync();
}
}  // namespace emu

inline void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                uint64_t desc, bool accumulate) {
  emu::wgmma_k8_tf32<64>(d, a, desc, accumulate);
}
inline void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                 uint64_t desc, bool accumulate) {
  emu::wgmma_k8_tf32<128>(d, a, desc, accumulate);
}

inline void tf32_split(uint32_t v, uint32_t& hi, uint32_t& lo) {
  float f, h;
  std::memcpy(&f, &v, 4);
  hi = emu::tf32_rna(f);
  std::memcpy(&h, &hi, 4);
  lo = emu::tf32_rna(f - h);
}

inline void warp_sync() { ::mock::warp_sync(); }

inline float shfl_xor(float v, int m) {
  uint32_t* s = ::mock::warp_scratch();
  const int lane = threadIdx.x % 32;
  std::memcpy(&s[lane], &v, 4);
  ::mock::warp_sync();
  float r;
  std::memcpy(&r, &s[lane ^ m], 4);
  ::mock::warp_sync();
  return r;
}

// The barrier's 8 bytes: pending arrivals (bits 0-31), the count (32-62)
// and the current phase's parity (63).
namespace emu {
inline std::atomic_ref<uint64_t> mbar_at(uint32_t addr) {
  return std::atomic_ref<uint64_t>(
      *reinterpret_cast<uint64_t*>(::mock::smem_base() + addr));
}
}  // namespace emu
inline void mbar_init(uint32_t addr, uint32_t count) {
  emu::mbar_at(addr).store(((uint64_t)count << 32) | count);
}
inline void mbar_arrive(uint32_t addr) {
  auto b = emu::mbar_at(addr);
  uint64_t old = b.load();
  for (;;) {
    const uint32_t pending = (uint32_t)old;
    if (pending == 0) std::abort();  // more arrivals than the count
    const uint64_t next =
        pending == 1 ? ((old ^ (1ull << 63)) & ~0xFFFFFFFFull) |
                           ((old >> 32) & 0x7FFFFFFFu)
                     : old - 1;
    if (b.compare_exchange_weak(old, next)) return;
  }
}
// the thread's copies land here, all of its groups, then the arrival
inline void cp_async_mbar_arrive(uint32_t addr) {
  for (const auto& group : emu::groups)
    for (const emu::Copy& c : group)
      std::memcpy(::mock::smem_base() + c.dst, c.bytes, c.n);
  emu::groups.assign(1, {});
  mbar_arrive(addr);
}
inline void mbar_wait(uint32_t addr, uint32_t parity) {
  while ((emu::mbar_at(addr).load() >> 63) == parity)
    std::this_thread::yield();
}
inline void fence_proxy_async() {}

#endif  // CID_EMULATE_MMA

}  // namespace mma
}  // namespace cid
