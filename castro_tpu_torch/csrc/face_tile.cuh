// The thread-block tile of the two face kernels (trace_ppm.cu, ctu_face.cu):
// one thread a cell, LEN cells a tile along the normal direction D.
//
// Thread i of a tile takes cell p = f0 - 1 + i, computes what that cell
// gives its two faces (the traced or transverse-corrected left-edge state
// of face p and right-edge state of face p + 1), and exchanges the
// right-edge state with thread i + 1 in shared memory. Thread 0 is the
// low halo: it feeds face f0 only. With HI = 1 the last thread is a high
// halo as well: it solves its face for the cell below (the consup fold)
// and owns nothing. A tile owns OWN = LEN - 1 - HI faces (and cells).
//
// The other extent of the block runs along z, the contiguous axis, so that
// neighbouring threads read neighbouring addresses: BX z columns of LEN = BY
// cells along D for D = 0, 1; for D = 2 the tile itself runs along z
// (LEN = BX) and the block stacks BY rows of y. Each kernel picks its block
// shape per direction (the fastest of those timed on an H100 with
// castro_tpu_torch/scripts/prof_faces.py). The grid's extents are not multiples of
// the tile, so threads past the grid's edge (`in` false) compute nothing
// but still reach every barrier. The edge clamp of ops/stencil.py:shifted
// is the grid's: the low halo of the first tile is cell 0 itself (p = -1
// clamped), so face 0's left state is cell 0's right-edge state, and
// neighbours along D are clamped to [0, n_D).
#pragma once

#include "common.cuh"

namespace ctt {

template <int D, int HI, int BX_, int BY_>
struct FaceTile {
  static constexpr int BX = BX_;  // threadIdx.x, along z
  static constexpr int BY = BY_;  // threadIdx.y, along D (y for D = 2)
  static constexpr int THREADS = BX * BY;
  static constexpr int LEN = D == 2 ? BX : BY;  // cells along D, halos included
  static constexpr int OWN = LEN - 1 - HI;
  static constexpr int STEP = D == 2 ? 1 : BX;  // slot distance to the next cell along D

  int r;          // place in the tile along D: 0 is the low halo
  int p;          // position along D; -1 for the halo below the grid
  bool in;        // p < n_D and the column inside the grid
  Cell x;         // the cell, p clamped to 0
  long long i0;   // linear index of the column's cell at position 0
  long long sd;   // stride along D
  int slot;       // the thread's slot in the block's shared arrays

  __device__ __forceinline__ explicit FaceTile(const Grid& g) {
    if constexpr (D == 2) {
      r = threadIdx.x;
      p = blockIdx.x * OWN + r - 1;
      x.c[1] = blockIdx.y * BY + threadIdx.y;
      x.c[0] = blockIdx.z;
      in = x.c[1] < g.n[1];
    } else {
      x.c[2] = blockIdx.x * BX + threadIdx.x;
      r = threadIdx.y;
      p = blockIdx.y * OWN + r - 1;
      x.c[1 - D] = blockIdx.z;
      in = x.c[2] < g.n[2];
    }
    in = in && p < g.n[D];
    x.c[D] = 0;
    i0 = x.at(g);
    x.c[D] = p < 0 ? 0 : p;
    sd = g.stride(D);
    slot = threadIdx.y * BX + threadIdx.x;
  }
  // linear index of position q along D in this column, q clamped to the grid
  __device__ __forceinline__ long long at(const Grid& g, int q) const {
    return i0 + clampi(q, g.n[D]) * sd;
  }
  // the cell's own linear index
  __device__ __forceinline__ long long ix() const { return i0 + x.c[D] * sd; }
  // whether face p (and, with HI, cell p) is this tile's to write
  __device__ __forceinline__ bool owns() const { return in && r >= 1 && r <= OWN; }
  // whether this thread solves face p (the owned faces and the high halo)
  __device__ __forceinline__ bool solves() const { return in && r >= 1; }

  static dim3 threads() { return dim3(BX, BY); }
  static dim3 blocks(const Grid& g) {
    auto up = [](int n, int b) { return (unsigned)((n + b - 1) / b); };
    if constexpr (D == 2) return dim3(up(g.n[2], OWN), up(g.n[1], BY), g.n[0]);
    return dim3(up(g.n[2], BX), up(g.n[D], OWN), g.n[1 - D]);
  }
};

}  // namespace ctt
